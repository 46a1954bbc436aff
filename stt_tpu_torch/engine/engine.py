"""WhisperEngine: one device-resident model serving many sessions.

Counterpart of ``stt_tpu/engine/engine.py`` for the serving step at beam 1
without timestamps — what every streaming partial and final takes:

- Requests enter a queue; the engine thread collects up to ``max_batch``
  of them within ``batch_window_ms``, groups compatible requests (same
  audio bucket, same prompt shape and policy) and runs one batched
  mel -> encode -> detect -> greedy-decode step per group.
- Audio pads to second buckets and rows to batch buckets, as in the JAX
  package, so the shapes a deployment sees stay few.
- Rows travel to the device on the audio wire (``audio_wire``): 8-bit
  mu-law by default (a quarter of float32), or the lossless int16 PCM
  rows for any other value; the hand-written log-mel kernel expands
  either while it loads them.
- Three attention options (``cross_kv_dtype``, ``xattn_kernel``,
  ``flash_attention``; :class:`~stt_tpu_torch.models.whisper.AttentionPolicy`)
  pick the cross K/V storage and the cross-attention decode and encoder
  flash kernels. Each one left None is read once, when the engine is
  built, from the JAX package's environment variable of the same meaning
  (``STT_CROSS_KV_DTYPE``, ``STT_XATTN_KERNEL``, ``STT_FLASH_ATTENTION``),
  with its defaults (int8, off, off). The flash kernel has a bf16 body
  and a float32 one, so either compute type serves with flash on.
  ``audio_wire`` and ``pipeline_depth`` are read the same way from
  ``STT_AUDIO_WIRE`` (default mulaw) and ``STT_PIPELINE_DEPTH`` (default 2),
  parsed as the JAX package parses them.
- The greedy decode of each group runs on its shape's entry in the decode
  graph cache (:class:`~stt_tpu_torch.engine.graphs.DecodeGraphs`, the JAX
  engine's exec cache): on the card a captured CUDA graph of the decode
  chunk, replayed, and never an eager fallback; on the CPU the same chunk
  uncaptured. :meth:`WhisperEngine.prewarm` builds the entries (and the
  kernels, and cuBLAS's choices) of the shapes a deployment serves before
  it serves them, so nothing is captured at serving time.
- The device phase returns one packed int32 array per group (tokens,
  lengths, logprob sum, p(no_speech), language index and probability);
  a harvester thread reads it back, detokenizes and resolves the futures,
  so the engine thread can form the next batch meanwhile. At most
  ``pipeline_depth`` groups are in flight.

Both threads are daemon threads, and :meth:`WhisperEngine.close` joins
them with timeouts and fails any request still queued, so no future is
left pending and no thread outlives the interpreter.

Left for later slices (a request asking for them raises
``NotImplementedError`` naming the option): beam search, timestamps,
sampling and the temperature ladder, repetition penalty and n-gram bans,
forced prefixes and conditioning prompts, clip ranges, word timestamps,
drafted partials and the long-audio seek loop.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..backends.base import BackendInfo, Segment
from ..device import resolve_device
from ..models import whisper as W
from ..models.tokenizer import load_tokenizer
from ..ops.kernels.mel import mel_logspec
from ..ops.mel import HOP_LENGTH, SAMPLE_RATE, normalize_log_mel
from .graphs import DecodeGraphs

LOGGER = logging.getLogger("stt_tpu_torch")

DEFAULT_AUDIO_BUCKETS_SEC = (1.0, 2.0, 5.0, 10.0, 30.0)
DEFAULT_BATCH_BUCKETS = (1, 4, 16)
# groups whose device work is enqueued but not yet harvested, unless
# STT_PIPELINE_DEPTH or the engine's pipeline_depth says otherwise
PIPELINE_DEPTH = 2
# how long close() waits for each thread to stop
CLOSE_JOIN_TIMEOUT_SEC = 120.0


def _build_mulaw_lut() -> np.ndarray:
    """int16 -> mu-law uint8 lookup table, indexed by the int16 value
    REINTERPRETED as uint16 (so encoding is one zero-copy gather:
    ``lut[rows.view(np.uint16)]``)."""
    u = np.arange(65536, dtype=np.int64)
    x = np.where(u < 32768, u, u - 65536).astype(np.float32) / 32768.0
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log(256.0)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


_MULAW_LUT = _build_mulaw_lut()


def _encode_wire_rows(rows: np.ndarray, wire: str = "mulaw") -> np.ndarray:
    """Packed int16 PCM rows -> the ``wire`` format: the 8-bit mu-law codes
    for ``"mulaw"``, the int16 rows unchanged for any other wire."""
    if wire == "mulaw":
        return _MULAW_LUT[rows.view(np.uint16)]
    return rows


def _audio_wire(given: Optional[str]) -> str:
    """The engine's audio wire: ``given``, else ``STT_AUDIO_WIRE``, stripped
    and lower-cased, empty meaning mulaw (``stt_tpu/engine/engine.py:68``).
    Every wire but mulaw ships the int16 rows, so it is named ``int16``."""
    raw = os.getenv("STT_AUDIO_WIRE", "mulaw") if given is None else given
    return "mulaw" if (raw.strip().lower() or "mulaw") == "mulaw" else "int16"


def _pipeline_depth(given: Optional[int]) -> int:
    """Groups in flight: ``given``, else ``STT_PIPELINE_DEPTH`` (default 2, an
    unparsable value also 2), at least 1 (``stt_tpu/engine/engine.py:1143``)."""
    if given is None:
        try:
            given = int(os.getenv("STT_PIPELINE_DEPTH", str(PIPELINE_DEPTH))
                        or PIPELINE_DEPTH)
        except ValueError:
            given = PIPELINE_DEPTH
    return max(1, int(given))


def max_new_for(bucket_sec: float, max_decode_tokens: int) -> int:
    """Decode-loop bound for one audio bucket: ~7.5 tokens/sec of audio
    at 30 s = 224, rounded up to a multiple of 8 (a multiple of 8 whenever
    ``max_decode_tokens`` is one, as the engine requires)."""
    est = int(np.ceil(bucket_sec * max_decode_tokens / 30.0 / 8.0)) * 8
    return int(min(max_decode_tokens, max(24, est)))


@dataclass
class DecodeRequest:
    audio: np.ndarray                      # float32 mono @ 16 kHz
    language: Optional[str] = None         # None/"" -> auto-detect
    task: str = "transcribe"
    options: Dict[str, Any] = field(default_factory=dict)
    is_final: bool = False
    session_id: str = ""


@dataclass
class DecodeOutput:
    segments: List[Segment]
    info: BackendInfo
    inference_sec: float = 0.0
    batch_rows: int = 0
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0
    # the decoded token row + prompt length that produced this output
    _tokens: Any = None
    _p_len: int = 0
    _n_gen: int = 0


class _Task:
    __slots__ = ("request", "future", "cancel_event")

    def __init__(self, request: DecodeRequest,
                 cancel_event: Optional[threading.Event]) -> None:
        self.request = request
        self.future: Future = Future()
        self.cancel_event = cancel_event


def _unsupported_option(options: Dict[str, Any]) -> Optional[str]:
    """The first option that asks for behaviour this slice does not serve,
    as ``"name=value"``, or None. Values that mean "off" pass."""
    def off(name, *defaults):
        value = options.get(name)
        return value is None or value in defaults

    checks = [
        ("beam_size", off("beam_size", 0, 1, "1")),
        ("without_timestamps", bool(options.get("without_timestamps", True))),
        ("word_timestamps", not options.get("word_timestamps")),
        ("clip_timestamps", off("clip_timestamps", "", "0", 0, [0], [0.0])),
        ("prefix", not str(options.get("prefix") or "").strip()),
        ("initial_prompt", not str(options.get("initial_prompt") or "").strip()),
        ("hotwords", not str(options.get("hotwords") or "").strip()),
        ("repetition_penalty", off("repetition_penalty", 0, 1, 1.0, "1")),
        ("no_repeat_ngram_size", off("no_repeat_ngram_size", 0, "0")),
    ]
    temp = options.get("temperature", 0.0)
    if isinstance(temp, (list, tuple)):
        checks.append(("temperature", [float(t) for t in temp] in ([], [0.0])))
    else:
        checks.append(("temperature", float(temp or 0.0) == 0.0))
    for name, ok in checks:
        if not ok:
            return f"{name}={options.get(name)!r}"
    return None


def _pack_result(res: W.DecodeResult, lang_idx: torch.Tensor,
                 lang_p: torch.Tensor) -> torch.Tensor:
    """One int32 array (B, T_max + 5): [tokens | lengths |
    bitcast(sum_logprob) | bitcast(no_speech_prob) | lang_idx |
    bitcast(lang_prob)], so the host reads every output in one transfer."""
    def bits(x):
        return x.to(torch.float32).contiguous().view(torch.int32)[:, None]

    return torch.cat(
        [
            res.tokens.to(torch.int32),
            res.lengths.to(torch.int32)[:, None],
            bits(res.sum_logprob),
            bits(res.no_speech_prob),
            lang_idx.to(torch.int32)[:, None],
            bits(lang_p),
        ],
        dim=1,
    )


def _mel_encode(model: W.Whisper, rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wire rows (B, T) -> encoder states. On the card the log-mel runs in
    the hand-written kernel (mu-law expansion fused into its load)."""
    raw = mel_logspec(rows, model.config.n_mels)
    mel = normalize_log_mel(raw).to(dtype)
    return model.encoder(mel)


def _detect_and_patch_lang(model: W.Whisper, enc: torch.Tensor, prompt: torch.Tensor,
                           auto_mask: torch.Tensor, cross_kv: W.CrossKV,
                           lang_pos: int):
    """On-device language detection; rows flagged by ``auto_mask`` get the
    detected language written into their prompt's language slot. Returns
    ``(prompt, lang_idx, lang_p)``."""
    layout = W.token_layout(model.config.n_vocab)
    given_idx = prompt[:, lang_pos] - layout.lang_begin
    probs = W.detect_language(model, enc, cross_kv)
    det_idx = torch.argmax(probs, dim=-1)
    det_p = torch.amax(probs, dim=-1)
    lang_idx = torch.where(auto_mask, det_idx, given_idx)
    lang_p = torch.where(auto_mask, det_p, torch.ones_like(det_p))
    prompt = prompt.clone()
    prompt[:, lang_pos] = layout.lang_begin + lang_idx
    return prompt, lang_idx, lang_p


def _decode_serve(model: W.Whisper, graphs: DecodeGraphs, bucket_sec: float,
                  enc: torch.Tensor, prompt: torch.Tensor, prompt_len: torch.Tensor,
                  auto_mask: torch.Tensor, max_new_tokens: int,
                  suppress_blank: bool = True, lang_pos: int = 1) -> torch.Tensor:
    """Language detection -> greedy decode -> packed outputs, from an
    encoder output, on the shape's entry of ``graphs``: the cross K/V is
    computed once into the entry's buffers and shared by the detection step
    and the decode. The packed result is a new tensor, enqueued after the
    decode's last replay, so a next group of the same shape may reuse the
    entry before this one is harvested."""
    entry = graphs.entry(bucket_sec, enc.shape[0], prompt.shape[1], max_new_tokens,
                         enc.shape[1])
    cross_kv = W.precompute_cross_kv(model.decoder, enc, out=entry.cross_kv)
    prompt, lang_idx, lang_p = _detect_and_patch_lang(
        model, enc, prompt, auto_mask, cross_kv, lang_pos
    )
    res = graphs.decode(entry, prompt, prompt_len, suppress_blank=suppress_blank,
                        sot_pos=lang_pos - 1)
    return _pack_result(res, lang_idx, lang_p)


def _serve_step(model: W.Whisper, graphs: DecodeGraphs, bucket_sec: float,
                rows: torch.Tensor, prompt: torch.Tensor, prompt_len: torch.Tensor,
                auto_mask: torch.Tensor, dtype: torch.dtype, max_new_tokens: int,
                suppress_blank: bool = True) -> torch.Tensor:
    """The whole serving step: mel + encoder, then detect + decode + pack."""
    enc = _mel_encode(model, rows, dtype)
    return _decode_serve(model, graphs, bucket_sec, enc, prompt, prompt_len, auto_mask,
                         max_new_tokens, suppress_blank)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class WhisperEngine:
    """Batched Whisper inference on one device (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(
        self,
        model_size: str,
        device: Optional[Union[str, torch.device]] = None,
        compute_type: str = "bfloat16",
        *,
        tokenizer_path: Optional[str] = None,
        audio_buckets_sec: Sequence[float] = DEFAULT_AUDIO_BUCKETS_SEC,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        max_decode_tokens: int = 224,
        batch_window_ms: float = 5.0,
        max_batch: int = 16,
        seed: int = 0,
        cross_kv_dtype: Optional[str] = None,
        xattn_kernel: Optional[str] = None,
        flash_attention: Optional[str] = None,
        audio_wire: Optional[str] = None,
        pipeline_depth: Optional[int] = None,
    ) -> None:
        if compute_type not in _DTYPES:
            raise ValueError(f"compute_type must be one of {sorted(_DTYPES)}, "
                             f"got {compute_type!r}")
        if int(max_decode_tokens) <= 0 or int(max_decode_tokens) % W.FINISH_CHECK_EVERY:
            # the decode graphs replay chunks of FINISH_CHECK_EVERY steps, and
            # max_new_for keeps every bucket's bound a multiple of it only then
            raise ValueError(f"max_decode_tokens={max_decode_tokens} must be a positive "
                             f"multiple of {W.FINISH_CHECK_EVERY}")
        self.model_size = model_size
        self.device = resolve_device(device)
        self._dtype = _DTYPES[compute_type]
        config = W.get_config(model_size)
        self.config = config
        self.policy = W.AttentionPolicy.from_env(
            cross_kv_dtype=cross_kv_dtype, xattn_kernel=xattn_kernel,
            flash_attention=flash_attention,
        )
        self.model = W.build_model(
            config, W.init_params(config, seed=seed), self.device, self._dtype,
            self.policy,
        )
        self.graphs = DecodeGraphs(self.model, self.device, self._dtype)
        self.audio_wire = _audio_wire(audio_wire)
        self.pipeline_depth = _pipeline_depth(pipeline_depth)
        self.tokenizer = load_tokenizer(tokenizer_path, config.n_vocab)
        self.layout = W.token_layout(config.n_vocab)

        self.audio_buckets_sec = tuple(sorted(audio_buckets_sec))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_decode_tokens = int(max_decode_tokens)
        self.batch_window_sec = max(0.0, float(batch_window_ms) / 1000.0)
        self.max_batch = max(1, int(max_batch))

        self._queue: "queue.Queue[Optional[_Task]]" = queue.Queue()
        self._harvest_q: "queue.Queue[Optional[Tuple[List[_Task], Dict[str, Any]]]]" = (
            queue.Queue()
        )
        self._dispatch_sem = threading.Semaphore(self.pipeline_depth)
        self._thread: Optional[threading.Thread] = None
        self._harvest_thread: Optional[threading.Thread] = None
        self._running = False
        self._closing = False
        self._lock = threading.Lock()
        # one group at a time enqueues device work: the graph entries'
        # buffers are shared by every group of their shape
        self._device_lock = threading.Lock()

    @property
    def graph_captures(self) -> int:
        """Decode graphs captured so far (the JAX engine's compiles)."""
        return self.graphs.graph_captures

    @property
    def graph_replays(self) -> int:
        """Decode-chunk graph replays so far (the JAX engine's cache loads)."""
        return self.graphs.graph_replays

    # -- sizing ---------------------------------------------------------------

    def _bucket_for(self, n_samples: int) -> float:
        seconds = n_samples / SAMPLE_RATE
        for b in self.audio_buckets_sec:
            if seconds <= b:
                return b
        return self.audio_buckets_sec[-1]

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _max_new_for(self, bucket_sec: float) -> int:
        return max_new_for(bucket_sec, self.max_decode_tokens)

    def _check_supported(self, request: DecodeRequest) -> None:
        bad = _unsupported_option(request.options)
        if bad is not None:
            raise NotImplementedError(
                f"option {bad} is not served by stt_tpu_torch yet "
                f"(it serves greedy decodes without timestamps so far)"
            )
        max_win = int(self.audio_buckets_sec[-1] * SAMPLE_RATE)
        max_win -= max_win % HOP_LENGTH
        if request.is_final and len(request.audio) > max_win:
            raise NotImplementedError(
                f"long-audio seek loop: a final of {len(request.audio)} "
                f"samples exceeds the largest window ({max_win} samples)"
            )

    # -- public API -----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running or self._closing:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name=f"engine-{self.model_size}", daemon=True
            )
            self._thread.start()
            self._harvest_thread = threading.Thread(
                target=self._harvest_loop,
                name=f"engine-harvest-{self.model_size}", daemon=True,
            )
            self._harvest_thread.start()

    def close(self) -> None:
        """Stop both threads (joined with timeouts) and fail anything still
        queued. The engine can be started again afterwards."""
        with self._lock:
            if not self._running:
                return
            self._running = False
            self._closing = True
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=CLOSE_JOIN_TIMEOUT_SEC)
            if self._thread.is_alive():
                LOGGER.error("engine thread still alive after %.0f s",
                             CLOSE_JOIN_TIMEOUT_SEC)
            self._thread = None
        # the engine thread has stopped dispatching: the harvester drains
        # everything it enqueued, then stops at the sentinel
        self._harvest_q.put(None)
        if self._harvest_thread is not None:
            self._harvest_thread.join(timeout=CLOSE_JOIN_TIMEOUT_SEC)
            self._harvest_thread = None
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            if leftover is not None and not leftover.future.done():
                leftover.future.set_exception(
                    RuntimeError("engine closed before the request ran")
                )
        self._closing = False

    def submit(self, request: DecodeRequest,
               cancel_event: Optional[threading.Event] = None) -> Future:
        """Queue a request for the batching loop; returns a Future. Raises
        ``NotImplementedError`` for options this slice does not serve."""
        self._check_supported(request)
        task = _Task(request, cancel_event)
        while True:
            self.start()  # no-op while running or closing
            with self._lock:
                if self._closing:
                    task.future.set_exception(RuntimeError("engine is shutting down"))
                    return task.future
                if self._running:
                    self._queue.put(task)
                    return task.future
            # close() finished between start() and the lock; retry

    def transcribe_sync(self, request: DecodeRequest) -> DecodeOutput:
        """Run one request on the calling thread (no batching)."""
        self._check_supported(request)
        task = _Task(request, None)
        return self._harvest(self._device_phase([task]))[0]

    def prewarm(
        self,
        bucket_secs: Optional[Sequence[float]] = None,
        batch_sizes: Optional[Sequence[int]] = None,
        *,
        include_detect: bool = False,
        beam_sizes: Optional[Sequence[int]] = None,
        parallelism: int = 1,
        mode: str = "execute",
        include_drafted: bool = False,
    ) -> float:
        """Build every (audio bucket, batch bucket) shape up front; returns
        the wall time in seconds (``stt_tpu/engine/engine.py:1293``).

        Each combination (``bucket_secs``, default every audio bucket, by
        ``batch_sizes``, default the smallest batch bucket) runs one group
        of zero-audio rows through the device phase: that builds the kernels
        (``ops/cuda/build.py``), sets their function attributes, lets cuBLAS
        and cuDNN pick their algorithms and captures the shape's decode
        graph, so serving those shapes captures nothing. ``include_detect``
        is accepted for call sites and unused (every group can detect);
        ``parallelism`` is accepted and the shapes are built one after
        another, since captures share one device and one memory pool. Raises
        ``NotImplementedError`` for ``mode="aot"`` (ahead-of-time compiles
        have no counterpart on the card), beam sizes above 1 and
        ``include_drafted``: those belong to later slices.
        """
        del include_detect, parallelism
        if mode != "execute":
            raise NotImplementedError(
                f"prewarm option mode={mode!r} is not served by stt_tpu_torch "
                f"(only 'execute'; ahead-of-time compiles have no counterpart on the card)"
            )
        if any(int(b) > 1 for b in (beam_sizes or ())):
            raise NotImplementedError(
                f"prewarm option beam_sizes={list(beam_sizes)!r} is not served by "
                f"stt_tpu_torch yet (greedy decodes only)"
            )
        if include_drafted:
            raise NotImplementedError(
                "prewarm option include_drafted=True is not served by stt_tpu_torch yet "
                "(drafted partials are a later slice)"
            )
        t0 = time.monotonic()
        for sec in bucket_secs or self.audio_buckets_sec:
            for rows in batch_sizes or (self.batch_buckets[0],):
                audio = np.zeros(int(float(sec) * SAMPLE_RATE), np.float32)
                group = [_Task(DecodeRequest(audio=audio, language="en"), None)
                         for _ in range(int(rows))]
                self._harvest(self._device_phase(group))
        return time.monotonic() - t0

    # -- threads --------------------------------------------------------------

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
                    self._queue.put(None)  # re-post sentinel for the outer loop
                    break
                batch.append(nxt)
            self._process(batch)

    def _group_key(self, task: _Task) -> Tuple:
        """Two requests share a batch only when their audio bucket, prompt
        length and group-wide decode policy match."""
        request = task.request
        bucket = self._bucket_for(len(request.audio))
        p_len = len(self._prompt_for(request))
        suppress_blank = bool(request.options.get("suppress_blank", True))
        return (bucket, p_len, suppress_blank)

    def _process(self, batch: List[_Task]) -> None:
        live: List[_Task] = []
        for task in batch:
            if task.cancel_event is not None and task.cancel_event.is_set():
                task.future.cancel()
                continue
            if task.future.set_running_or_notify_cancel():
                live.append(task)
        groups: Dict[Tuple, List[_Task]] = {}
        for task in live:
            groups.setdefault(self._group_key(task), []).append(task)
        max_rows = self.batch_buckets[-1]
        for group in groups.values():
            for start in range(0, len(group), max_rows):
                sub = group[start:start + max_rows]
                # bounds the groups in flight; the harvester releases
                self._dispatch_sem.acquire()
                try:
                    ctx = self._device_phase(sub)
                except Exception as exc:
                    self._dispatch_sem.release()
                    LOGGER.exception("device phase failed")
                    for task in sub:
                        if not task.future.done():
                            task.future.set_exception(exc)
                    continue
                self._harvest_q.put((sub, ctx))

    def _harvest_loop(self) -> None:
        """Readback, detokenization and future resolution, in dispatch order."""
        while True:
            item = self._harvest_q.get()
            if item is None:
                return
            sub, ctx = item
            try:
                outputs = self._harvest(ctx)
            except Exception as exc:
                LOGGER.exception("harvest failed")
                for task in sub:
                    if not task.future.done():
                        task.future.set_exception(exc)
            else:
                for task, out in zip(sub, outputs):
                    if not task.future.done():
                        task.future.set_result(out)
            finally:
                self._dispatch_sem.release()

    # -- the batched serving step ---------------------------------------------

    def _prompt_for(self, request: DecodeRequest) -> List[int]:
        """SOT sequence; the language slot holds a placeholder for
        auto-detect rows and is overwritten on device."""
        return W.build_prompt(self.config, request.language or "en",
                              task=request.task, without_timestamps=True)

    def _device_phase(self, group: List[_Task]) -> Dict[str, Any]:
        """Host prep and every device launch for one group; returns a
        context whose ``packed`` tensor is still on the device."""
        t_start = time.monotonic()
        n = len(group)
        bucket_sec = max(self._bucket_for(len(t.request.audio)) for t in group)
        bucket_samples = int(bucket_sec * SAMPLE_RATE)
        bucket_samples -= bucket_samples % HOP_LENGTH
        batch_n = self._batch_bucket(n)

        # rows pack to int16 PCM, then go to the engine's audio wire (mu-law
        # or the int16 rows) for the host->device hop; the log-mel kernel
        # expands either on load
        rows = np.zeros((batch_n, bucket_samples), np.int16)
        durations = []
        for i, task in enumerate(group):
            audio = task.request.audio
            if len(audio) > bucket_samples:
                # partial-window semantics: a live caption needs the newest audio
                audio = audio[-bucket_samples:]
            rows[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
            durations.append(len(audio) / SAMPLE_RATE)

        langs: List[Optional[str]] = []
        auto_mask = np.zeros((batch_n,), np.bool_)
        prompts = []
        for i, task in enumerate(group):
            lang = task.request.language
            auto_mask[i] = not lang
            langs.append(lang or None)
            prompts.append(self._prompt_for(task.request))
        p_len = len(prompts[0])
        prompt_arr = np.full((batch_n, p_len), self.layout.eot, np.int64)
        for i, p in enumerate(prompts):
            prompt_arr[i] = p
        max_new = self._max_new_for(bucket_sec)
        suppress_blank = all(
            bool(t.request.options.get("suppress_blank", True)) for t in group
        )

        dev = self.device
        with self._device_lock, torch.inference_mode():
            rows_dev = torch.from_numpy(_encode_wire_rows(rows, self.audio_wire)).to(dev)
            packed = _serve_step(
                self.model, self.graphs, bucket_sec, rows_dev,
                torch.from_numpy(prompt_arr).to(dev),
                torch.full((batch_n,), p_len, dtype=torch.long, device=dev),
                torch.from_numpy(auto_mask).to(dev),
                self._dtype, max_new, suppress_blank,
            )
        return {
            "group": group, "packed": packed, "rows_dev": rows_dev,
            "durations": durations,
            "langs": langs, "p_len": p_len, "batch_n": batch_n, "n": n,
            "bucket_sec": bucket_sec, "max_new": max_new, "t_start": t_start,
        }

    def _harvest(self, ctx: Dict[str, Any]) -> List[DecodeOutput]:
        """Blocking readback + host postprocessing for one group."""
        group = ctx["group"]
        durations = ctx["durations"]
        p_len = ctx["p_len"]
        arr = ctx["packed"].cpu().numpy()  # the ONE device->host transfer
        t_max = arr.shape[1] - 5
        outputs = []
        for i, task in enumerate(group):
            lang = ctx["langs"][i]
            lang_p = 1.0
            if lang is None:
                idx = min(max(int(arr[i, t_max + 3]), 0), len(W.WHISPER_LANG_CODES) - 1)
                lang = W.WHISPER_LANG_CODES[idx]
                lang_p = float(arr[i, t_max + 4 : t_max + 5].view(np.float32)[0])
            n_gen = max(0, int(arr[i, t_max]) - p_len)
            gen_tokens = arr[i, p_len : p_len + n_gen]
            avg_lp = float(arr[i, t_max + 1 : t_max + 2].view(np.float32)[0] / max(1, n_gen))
            no_speech_p = float(arr[i, t_max + 2 : t_max + 3].view(np.float32)[0])
            text = self.tokenizer.decode(gen_tokens)
            segments = [Segment(0.0, durations[i], text)] if text.strip() else []
            # whisper no-speech rule: silence when p(no_speech) is high AND
            # the decode is low-confidence (faster_whisper defaults)
            opts = task.request.options
            ns_threshold = opts.get("no_speech_threshold", 0.6)
            lp_threshold = opts.get("log_prob_threshold", opts.get("logprob_threshold", -1.0))
            if (ns_threshold is not None and no_speech_p > float(ns_threshold)
                    and lp_threshold is not None and avg_lp < float(lp_threshold)):
                segments = []
            outputs.append(DecodeOutput(
                segments=segments, info=BackendInfo(lang, lang_p),
                batch_rows=ctx["n"], avg_logprob=avg_lp, no_speech_prob=no_speech_p,
                _tokens=arr[i, :t_max].astype(np.int32), _p_len=p_len, _n_gen=n_gen,
            ))
        elapsed = time.monotonic() - ctx["t_start"]
        for out in outputs:
            out.inference_sec = elapsed
        return outputs


__all__ = [
    "DEFAULT_AUDIO_BUCKETS_SEC",
    "DEFAULT_BATCH_BUCKETS",
    "DecodeOutput",
    "DecodeRequest",
    "WhisperEngine",
    "max_new_for",
]
