"""Model registry: named model pools with fair cross-session scheduling.

Counterpart of ``stt_tpu/engine/registry.py``, copied line for line but
where the card differs: ``load_model`` builds the port's
:class:`WhisperEngine` replicas on ``cuda:0..n-1`` (capped at
``torch.cuda.device_count()``) or one CPU engine for ``device="cpu"``;
``cpu`` names the host and ``cuda``, ``cuda:N``, ``gpu`` and ``tpu`` (the
accelerator name the shipped YAML uses) the card, which must be there; a
``mesh_shape`` other than 1x1 (an engine default, as the runtime passes
``--tpu-mesh-shape``) builds one engine split over that mesh, which needs
as many cards (or, on the host, takes as many CPU slots); prewarm runs
the engine's one mode (``execute``) at every beam width of the configured
decode profiles, and the drafted entries unless ``draft_mode`` is ``off``; and :meth:`EnginePool._dispatch` turns a refusal
from ``engine.submit`` into the task's exception instead of losing the
dispatcher thread.

Scheduling semantics are contract-identical to the reference registry
(``stt_server/backend/application/model_registry.py:95-713``):

- per-session FIFO queues with a rotation deque -> round-robin across
  sessions, at most ONE in-flight decode per session,
- a final decode cancels stale queued partials for its session,
- cooperative cancel of already-dispatched tasks via per-future events,
- unknown ``model_id`` falls back to the default pool,
- ``health_summary()`` feeds the /health endpoint.

The execution substrate is where this build diverges: instead of
``pool_size`` worker *threads* each calling a native library, a
``jax_whisper`` pool owns ``pool_size`` :class:`WhisperEngine` replicas —
each pinned to a distinct device — whose micro-batching loops serve every
session's tasks together (least-loaded replica wins). Protocol backends
without an engine (``fake``; any external ModelBackend) run on a classic
thread pool so the orchestrator above sees one uniform submit surface.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent import futures
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..backends import get_backend
from ..backends.base import Segment
from ..engine.engine import DecodeRequest, WhisperEngine
from ..utils.audio import pcm16_to_float32
from ..utils.logging import LOGGER
from ..ops.resample import resample_np

DEFAULT_MODEL_ID = "default"


class WorkerResult(NamedTuple):
    """Per-decode result record consumed by DecodeStream.emit_ready."""

    segments: List[Segment]
    language_code: str
    language_probability: float
    latency_sec: float
    rtf: float
    queue_wait_sec: float
    audio_duration: float
    # word-level [(start_sec, end_sec, word), ...] when the
    # word_timestamps decode option is on (engine DTW alignment)
    words: tuple = ()


@dataclass
class _Task:
    pcm: bytes
    sample_rate: int
    options: Optional[Dict[str, Any]]
    session_id: str
    is_final: bool
    submitted_at: float
    future: futures.Future
    cancel_event: threading.Event = field(default_factory=threading.Event)


class FairSessionQueue:
    """Round-robin-across-sessions task queue, one in-flight per session."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[_Task]] = {}
        self._order: Deque[str] = deque()
        self._inflight: set = set()
        self._closed = False

    def push(self, task: _Task) -> None:
        with self._cond:
            q = self._queues.setdefault(task.session_id, deque())
            if task.is_final:
                self._cancel_stale_partials(q)
            q.append(task)
            if task.session_id not in self._order:
                self._order.append(task.session_id)
            self._cond.notify_all()

    def _cancel_stale_partials(self, q: Deque[_Task]) -> None:
        kept: Deque[_Task] = deque(t for t in q if t.is_final)
        for t in q:
            if not t.is_final:
                t.future.cancel()
        q.clear()
        q.extend(kept)

    def _pop_locked(self) -> Optional[_Task]:
        checks = len(self._order)
        while checks > 0 and self._order:
            sid = self._order.popleft()
            checks -= 1
            q = self._queues.get(sid)
            if not q:
                self._queues.pop(sid, None)
                continue
            if sid in self._inflight:
                self._order.append(sid)
                continue
            if any(t.is_final for t in q):
                self._cancel_stale_partials(q)
            task = q.popleft() if q else None
            if task is None:
                self._queues.pop(sid, None)
                continue
            self._inflight.add(sid)
            if q:
                self._order.append(sid)
            else:
                self._queues.pop(sid, None)
            return task
        return None

    def pop(self, timeout: float = 0.1) -> Optional[_Task]:
        """Block up to ``timeout`` for a dispatchable task; None on idle or
        after close()."""
        with self._cond:
            task = self._pop_locked()
            if task is None and not self._closed:
                self._cond.wait(timeout=timeout)
                task = self._pop_locked()
            return task

    def release(self, session_id: str) -> None:
        with self._cond:
            self._inflight.discard(session_id)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())


def _prepare_audio(pcm: bytes, sample_rate: int) -> np.ndarray:
    audio = pcm16_to_float32(pcm)
    if sample_rate != 16000 and sample_rate > 0:
        audio = resample_np(audio, sample_rate, 16000)
    return audio


_CARD_NAMES = ("cuda", "gpu", "tpu")


def _replica_devices(device: str, pool_size: int) -> Optional[List[int]]:
    """The card indices of a pool's replicas, or None for one engine on the
    host. ``cpu`` names the host; ``cuda``, ``gpu`` and ``tpu`` (the shipped
    YAML's accelerator name) the cards ``0..pool_size-1``, and ``cuda:N``
    those from N on, capped at the cards there are. Asking for the card on a
    host without CUDA raises: nothing serves on the CPU in its place."""
    name = device.strip().lower()
    if name == "cpu":
        return None
    base, _, index = name.partition(":")
    if base not in _CARD_NAMES:
        raise ValueError(f"unknown device {device!r} (use 'cpu', 'cuda', 'cuda:N', "
                         f"'gpu' or 'tpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, but torch.cuda.is_available() is "
            f"false; set device: cpu to serve on the host"
        )
    count = torch.cuda.device_count()
    first = int(index) if index else 0
    if not 0 <= first < count:
        raise ValueError(f"device {device!r}: this host has {count} CUDA device(s)")
    return [(first + r) % count for r in range(max(1, min(pool_size, count)))]


class _BasePool:
    def __init__(self, model_id: str, options: Dict[str, Any]) -> None:
        self.model_id = model_id
        self.options = dict(options)
        self.queue = FairSessionQueue()
        self.closed = False

    # subclasses: start(), close(drain_timeout)

    def info(self) -> Dict[str, Any]:
        return {
            "model_id": self.model_id,
            "model_size": self.options.get("model_size"),
            "backend": self.options.get("backend"),
            "device": self.options.get("device"),
            "compute_type": self.options.get("compute_type"),
            "pool_size": self.options.get("pool_size", 1),
            "pending": self.queue.depth(),
        }


class EnginePool(_BasePool):
    """WhisperEngine replicas serving all sessions via micro-batching.

    ``pool_size`` maps to device replicas (reference `pool_size` worker
    threads -> engines pinned to distinct chips; SURVEY.md §5 "replicate
    whisper-small per core"). Tasks go to the least-loaded replica.
    """

    def __init__(
        self, model_id: str, options: Dict[str, Any],
        engines: "WhisperEngine | List[WhisperEngine]",
    ) -> None:
        super().__init__(model_id, options)
        if isinstance(engines, WhisperEngine):
            engines = [engines]
        self.engines: List[WhisperEngine] = list(engines)
        self.engine = self.engines[0]  # compat accessor
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name=f"dispatch-{model_id}", daemon=True
        )

    def start(self) -> None:
        for engine in self.engines:
            engine.start()
        self._dispatcher.start()

    def worker_count(self) -> int:
        return len(self.engines)

    def _pick_engine(self) -> WhisperEngine:
        return min(self.engines, key=lambda e: e.pending())

    def _dispatch_loop(self) -> None:
        while not (self.queue.closed and self.queue.depth() == 0):
            task = self.queue.pop(timeout=0.1)
            if task is None:
                if self.queue.closed:
                    return
                continue
            self._dispatch(task)

    def _dispatch(self, task: _Task) -> None:
        if task.future.cancelled() or task.cancel_event.is_set():
            self.queue.release(task.session_id)
            return
        try:
            audio = _prepare_audio(task.pcm, task.sample_rate)
        except Exception as exc:
            if not task.future.done():
                task.future.set_exception(exc)
            self.queue.release(task.session_id)
            return
        opts = dict(task.options or {})
        request = DecodeRequest(
            audio=audio,
            language=opts.get("language") or None,
            task=str(opts.get("task", "transcribe")),
            options=opts,
            is_final=task.is_final,
            session_id=task.session_id,
        )
        dispatch_time = time.perf_counter()
        try:
            inner = self._pick_engine().submit(request, cancel_event=task.cancel_event)
        except Exception as exc:
            # a refusal (NotImplementedError for an option this slice does
            # not serve) fails this task only; the dispatcher keeps running
            if not task.future.done():
                task.future.set_exception(exc)
            self.queue.release(task.session_id)
            return
        duration = len(audio) / 16000.0

        def _done(inner_future: futures.Future) -> None:
            self.queue.release(task.session_id)
            if task.future.done():
                return
            if inner_future.cancelled():
                task.future.cancel()
                return
            exc = inner_future.exception()
            if exc is not None:
                task.future.set_exception(exc)
                return
            out = inner_future.result()
            latency = out.inference_sec
            queue_wait = max(0.0, dispatch_time - task.submitted_at)
            rtf = latency / duration if duration > 0 else -1.0
            task.future.set_result(
                WorkerResult(
                    segments=out.segments,
                    language_code=out.info.language,
                    language_probability=out.info.language_probability,
                    latency_sec=latency,
                    rtf=rtf,
                    queue_wait_sec=queue_wait,
                    audio_duration=duration,
                    words=tuple(out.words),
                )
            )

        inner.add_done_callback(_done)

    def close(self, drain_timeout_sec: Optional[float] = None) -> None:
        self.closed = True
        self.queue.close()
        self._dispatcher.join(timeout=drain_timeout_sec or 10)
        for engine in self.engines:
            engine.close()


class ThreadPool(_BasePool):
    """Classic N-worker pool for protocol backends (fake/external)."""

    def __init__(
        self, model_id: str, options: Dict[str, Any], backends: List[Any]
    ) -> None:
        super().__init__(model_id, options)
        self.backends = backends
        self._threads = [
            threading.Thread(
                target=self._worker_loop,
                args=(b,),
                name=f"worker-{model_id}-{i}",
                daemon=True,
            )
            for i, b in enumerate(backends)
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def worker_count(self) -> int:
        return len(self.backends)

    def _worker_loop(self, backend: Any) -> None:
        while True:
            task = self.queue.pop(timeout=0.1)
            if task is None:
                if self.queue.closed:
                    return
                continue
            self._run(backend, task)

    def _run(self, backend: Any, task: _Task) -> None:
        try:
            if task.future.cancelled() or task.cancel_event.is_set():
                return
            started = time.perf_counter()
            audio = _prepare_audio(task.pcm, task.sample_rate)
            duration = len(audio) / 16000.0
            segments, info = backend.transcribe(audio, dict(task.options or {}))
            latency = time.perf_counter() - started
            if task.cancel_event.is_set():
                if not task.future.done():
                    task.future.set_exception(futures.CancelledError())
                return
            result = WorkerResult(
                segments=list(segments),
                language_code=info.language,
                language_probability=info.language_probability,
                latency_sec=latency,
                rtf=latency / duration if duration > 0 else -1.0,
                queue_wait_sec=max(0.0, started - task.submitted_at),
                audio_duration=duration,
            )
            if not task.future.done():
                task.future.set_result(result)
        except Exception as exc:
            if not task.future.done():
                task.future.set_exception(exc)
            LOGGER.exception("decode task failed model_id=%s", self.model_id)
        finally:
            self.queue.release(task.session_id)

    def close(self, drain_timeout_sec: Optional[float] = None) -> None:
        self.closed = True
        self.queue.close()
        for t in self._threads:
            t.join(timeout=drain_timeout_sec or 10)
        for b in self.backends:
            close = getattr(b, "close", None)
            if close:
                close()


class ModelRegistry:
    """Keyed pools of decode capacity with load/unload lifecycle."""

    def __init__(self, *, metrics=None, engine_defaults: Optional[Dict] = None):
        self._lock = threading.RLock()
        self._pools: Dict[str, _BasePool] = {}
        self._cancel_events: Dict[int, threading.Event] = {}
        self._metrics = metrics
        self._engine_defaults = dict(engine_defaults or {})
        self._default_model_id = DEFAULT_MODEL_ID

    # -- lifecycle ------------------------------------------------------------

    def load_model(self, model_id: str, options: Dict[str, Any]) -> None:
        """Create and start a pool. ``options`` follow the model-load-profile
        schema (model_size/device/compute_type/pool_size/backend/...)."""
        with self._lock:
            if model_id in self._pools:
                raise ValueError(f"model '{model_id}' already loaded")
        backend_name = str(options.get("backend", "torch_whisper"))
        model_size = str(options.get("model_size", "small"))
        device = str(options.get("device", "cuda"))
        compute_type = str(options.get("compute_type", "bfloat16"))
        pool_size = max(1, int(options.get("pool_size", 1)))

        backend_cls = get_backend(backend_name)
        if backend_cls.__name__ == "TorchWhisperBackend":
            engine_kwargs = dict(self._engine_defaults)
            do_prewarm = bool(
                options.get("prewarm", engine_kwargs.pop("prewarm", True))
            )
            prewarm_sizes = options.get(
                "prewarm_batch_sizes",
                engine_kwargs.pop("prewarm_batch_sizes", [1]),
            )
            # beam widths reachable through the configured decode profiles
            # (e.g. `accurate` beam_size=5), each prewarmed at boot
            prewarm_beams = options.get(
                "prewarm_beam_sizes",
                engine_kwargs.pop("prewarm_beam_sizes", [1]),
            )
            # accepted for config compatibility: the engine's prewarm has one
            # mode (execute every shape on the card) and builds the shapes
            # one after another, since captures share one memory pool
            engine_kwargs.pop("prewarm_parallelism", None)
            engine_kwargs.pop("prewarm_mode", None)
            engine_kwargs.update(
                {
                    k: options[k]
                    for k in (
                        "weights_path",
                        "tokenizer_path",
                        "audio_buckets_sec",
                        "batch_buckets",
                        "max_decode_tokens",
                        "batch_window_ms",
                        "max_batch",
                        "use_pallas",
                        "pad_to_30s",
                        "draft_mode",
                    )
                    if k in options
                }
            )
            mesh_shape = engine_kwargs.pop("mesh_shape", None)
            if mesh_shape and tuple(mesh_shape) not in ((1,), (1, 1)):
                # ONE engine split over the mesh (stt_tpu/engine/registry.py:
                # 432-443) instead of per-card replicas: a card mesh needs
                # that many cards, a host mesh as many CPU slots
                indices = _replica_devices(device, 1)
                engines = [
                    WhisperEngine(
                        model_size,
                        "cpu" if indices is None else "cuda",
                        compute_type,
                        mesh_shape=tuple(mesh_shape),
                        metrics=self._metrics,
                        **engine_kwargs,
                    )
                ]
            else:
                # pool_size = number of device replicas (capped at the number
                # of cards; one engine per card), or one engine on the host
                indices = _replica_devices(device, pool_size)
                engine_device = "cpu" if indices is None else "cuda"
                engines = [
                    WhisperEngine(
                        model_size,
                        engine_device,
                        compute_type,
                        device_index=index,
                        metrics=self._metrics,
                        **engine_kwargs,
                    )
                    for index in (indices or [None])
                ]
            pool: _BasePool = EnginePool(model_id, options, engines)
            if do_prewarm and indices is not None:
                # build every reachable shape up front: a shape first met
                # while serving stalls its first decode for the capture
                t0 = time.monotonic()
                if prewarm_sizes:
                    sizes = sorted({
                        min(max(1, int(s)), engines[0].batch_buckets[-1])
                        for s in prewarm_sizes
                    })
                else:
                    sizes = list(engines[0].batch_buckets)
                beams = sorted({
                    max(1, min(int(bm), 8)) for bm in (prewarm_beams or [1])
                })
                for eng in engines:
                    # the drafted entries too wherever drafted partials may
                    # serve (under adaptive they may engage at any time)
                    eng.prewarm(
                        batch_sizes=sizes, include_detect=True, beam_sizes=beams,
                        mode="execute", include_drafted=eng._draft_mode != "off",
                    )
                LOGGER.info(
                    "prewarmed model_id=%s shapes=%sx%sx beams %s (%d decode graphs) "
                    "in %.1fs", model_id, engines[0].audio_buckets_sec, sizes, beams,
                    engines[0].graph_captures, time.monotonic() - t0,
                )
        else:
            backends = [
                backend_cls(model_size, device, compute_type)
                for _ in range(pool_size)
            ]
            pool = ThreadPool(model_id, options, backends)
        pool.start()
        with self._lock:
            self._pools[model_id] = pool
        LOGGER.info(
            "model loaded model_id=%s backend=%s size=%s pool_size=%d",
            model_id, backend_name, model_size, pool_size,
        )

    def unload_model(
        self, model_id: str, drain_timeout_sec: Optional[float] = None
    ) -> bool:
        with self._lock:
            if model_id == self._default_model_id:
                return False
            pool = self._pools.pop(model_id, None)
        if pool is None:
            return False
        pool.close(drain_timeout_sec)
        return True

    def close(self, drain_timeout_sec: Optional[float] = None) -> None:
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
        for pool in pools:
            pool.close(drain_timeout_sec)

    # -- queries --------------------------------------------------------------

    def list_models(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [pool.info() for pool in self._pools.values()]

    def has_model(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._pools

    def health_summary(self) -> Dict[str, Any]:
        with self._lock:
            pools = list(self._pools.values())
        return {
            "models_loaded": [p.model_id for p in pools],
            "total_workers": sum(p.worker_count() for p in pools),
            "empty_pools": sum(1 for p in pools if p.worker_count() == 0),
            "shutdown_workers": sum(1 for p in pools if p.closed),
        }

    # -- decode submission ----------------------------------------------------

    def _resolve_pool(self, model_id: str) -> Optional[_BasePool]:
        with self._lock:
            pool = self._pools.get(model_id)
            if pool is not None:
                return pool
            if model_id != self._default_model_id:
                pool = self._pools.get(self._default_model_id)
                if pool is not None:
                    LOGGER.warning(
                        "model '%s' not loaded; falling back to '%s'",
                        model_id, self._default_model_id,
                    )
                    return pool
            if self._pools:
                fallback = next(iter(self._pools.values()))
                LOGGER.warning(
                    "model '%s' not loaded; falling back to '%s'",
                    model_id, fallback.model_id,
                )
                return fallback
            return None

    def submit_decode(
        self,
        model_id: str,
        session_id: str,
        pcm: bytes,
        sample_rate: int,
        decode_options: Optional[Dict[str, Any]],
        is_final: bool,
    ) -> futures.Future:
        pool = self._resolve_pool(model_id)
        future: futures.Future = futures.Future()
        if pool is None:
            future.set_exception(RuntimeError("No model workers available"))
            return future
        task = _Task(
            pcm=pcm,
            sample_rate=sample_rate,
            options=dict(decode_options) if decode_options else None,
            session_id=session_id or "unknown",
            is_final=is_final,
            submitted_at=time.perf_counter(),
            future=future,
        )
        with self._lock:
            self._cancel_events[id(future)] = task.cancel_event
        future.add_done_callback(self._forget_cancel_event)
        pool.queue.push(task)
        return future

    def _forget_cancel_event(self, future: futures.Future) -> None:
        with self._lock:
            self._cancel_events.pop(id(future), None)

    def request_cancel(self, future: futures.Future) -> None:
        """Cooperatively cancel a dispatched decode (checked at batch
        formation / worker start)."""
        with self._lock:
            event = self._cancel_events.get(id(future))
        if event is not None:
            event.set()


__all__ = [
    "DEFAULT_MODEL_ID",
    "EnginePool",
    "FairSessionQueue",
    "ModelRegistry",
    "ThreadPool",
    "WorkerResult",
]
