"""Decode graphs: the port's counterpart of the JAX engine's exec cache.

The JAX package serves each shape as one compiled program: ``greedy_decode``
is a jitted ``lax.while_loop`` that decides on the device when to stop, its
programs sit in an exec cache (``stt_tpu/engine/engine.py:794``,
``:1390-1530``) and ``prewarm`` builds them before serving. The port keeps
one :class:`DecodeEntry` per (audio bucket, rows, prompt length, max_new,
compute type, attention policy):

- the decode state (:class:`~stt_tpu_torch.models.whisper.DecodeState`:
  self-KV cache, tokens, position, flags, logprob sums, the suppress and
  begin masks built once from numpy) and the cross K/V in the policy's
  storage (with int8 scales), allocated once;
- on the card, one ``torch.cuda.CUDAGraph`` of
  :func:`~stt_tpu_torch.models.whisper._decode_chunk` (``FINISH_CHECK_EVERY``
  steps), captured after one uncaptured warm-up on a side stream (which
  builds the kernels, sets their function attributes and lets cuBLAS pick
  its algorithms). Every entry's graph draws on one memory pool.

:meth:`DecodeGraphs.decode` runs the prefill eagerly, then replays the
chunk until every row has finished or ``max_new`` steps ran, reading
all-rows-finished on the host once per chunk, as the uncaptured loop does.
On the card serving goes through the graph and nothing else: a capture or a
replay that fails raises. On the CPU the entries hold the same buffers and
the same ``_decode_chunk`` runs uncaptured.

Kernel wrappers count their launches in Python, so a replay adds nothing
to them: each entry records the launches its capture made (one chunk's) and
its replays, and :meth:`DecodeGraphs.replayed_launches` multiplies them out.
``graph_captures`` and ``graph_replays`` play the part of the JAX engine's
``exec_cache_compiles`` and ``exec_cache_loads``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..models import whisper as W
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.mel import mel_logspec
from ..ops.kernels.xattn_decode import xattn_decode

# the kernel wrappers whose launch counts a capture records
KERNELS = {"mel_logspec": mel_logspec, "xattn_decode": xattn_decode,
           "flash_attention": flash_attention}


class GraphKey(NamedTuple):
    bucket_sec: float
    rows: int
    p_len: int
    max_new: int
    compute: torch.dtype
    policy: W.AttentionPolicy


@dataclass
class DecodeEntry:
    """The buffers, and on the card the graph, of one served shape."""

    key: GraphKey
    state: W.DecodeState
    cross_kv: W.CrossKV
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[str, int] = field(default_factory=dict)  # per replay (one chunk)
    replays: int = 0

    @property
    def chunks(self) -> int:
        return self.key.max_new // W.FINISH_CHECK_EVERY


class DecodeGraphs:
    """The entries of one model on one device, built on first use (or by
    the engine's ``prewarm``) and kept for the life of the cache."""

    def __init__(self, model: W.Whisper, device: torch.device, dtype: torch.dtype, *,
                 on_capture: Optional[Callable[[float], None]] = None) -> None:
        self.model = model
        self.device = device
        self.dtype = dtype
        # called with the seconds of each warm-up and capture (a metrics hook)
        self.on_capture = on_capture
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._entries: Dict[GraphKey, DecodeEntry] = {}
        self._lock = threading.Lock()
        self.graph_captures = 0
        self.graph_replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, bucket_sec: float, rows: int, p_len: int, max_new: int) -> GraphKey:
        """The entry key; ``max_new`` must be a positive multiple of
        ``FINISH_CHECK_EVERY`` (the engine's ``max_new_for`` always is), so
        the chunks cover it exactly."""
        if max_new <= 0 or max_new % W.FINISH_CHECK_EVERY:
            raise ValueError(f"max_new={max_new} is not a positive multiple of "
                             f"{W.FINISH_CHECK_EVERY}, the steps of one captured chunk")
        return GraphKey(float(bucket_sec), int(rows), int(p_len), int(max_new), self.dtype,
                        self.model.decoder.policy)

    def entry(self, bucket_sec: float, rows: int, p_len: int, max_new: int,
              n_audio: int) -> DecodeEntry:
        """The entry of this shape (``n_audio`` encoder positions at
        ``bucket_sec``), built and on the card captured on first use."""
        key = self.key(bucket_sec, rows, p_len, max_new)
        with self._lock:
            found = self._entries.get(key)
            if found is None:
                found = self._build(key, n_audio)
                self._entries[key] = found
        if found.cross_kv.k.shape[3] != n_audio:
            raise ValueError(f"{key}: built for {found.cross_kv.k.shape[3]} encoder "
                             f"positions, asked for {n_audio}")
        return found

    def lookup(self, bucket_sec: float, rows: int, p_len: int, max_new: int) -> DecodeEntry:
        """The entry of this shape if it was built; KeyError otherwise."""
        key = self.key(bucket_sec, rows, p_len, max_new)
        with self._lock:
            return self._entries[key]

    @torch.inference_mode(False)
    @torch.no_grad()
    def _build(self, key: GraphKey, n_audio: int) -> DecodeEntry:
        """Allocates the entry's buffers as normal tensors (also when the
        caller is in inference mode), so they can be updated in place
        anywhere; on the card warms up and captures the chunk."""
        dec = self.model.decoder
        entry = DecodeEntry(
            key=key,
            state=W.init_decode_state(self.model.config, key.rows, key.p_len, key.max_new,
                                      self.dtype, self.device),
            cross_kv=W.empty_cross_kv(dec, key.rows, n_audio, self.dtype, self.device),
        )
        if self.device.type != "cuda":
            return entry
        # a state the warm-up and the capture can step from: position p_len
        # with an eot prompt (any start a chunk of steps stays inside T_max)
        t0 = time.monotonic()
        st = entry.state
        st.tokens.fill_(W.token_layout(self.model.config.n_vocab).eot)
        st.prompt_len.fill_(key.p_len)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            st.pos.fill_(key.p_len)
            W._decode_chunk(dec, st, entry.cross_kv)
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.pos.fill_(key.p_len)
        before = {name: fn.launches for name, fn in KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            W._decode_chunk(dec, st, entry.cross_kv)
        entry.launches = {name: fn.launches - before[name] for name, fn in KERNELS.items()}
        entry.graph = graph
        self.graph_captures += 1
        if self.on_capture is not None:
            self.on_capture(time.monotonic() - t0)
        return entry

    @torch.no_grad()
    def decode(self, entry: DecodeEntry, prompt: torch.Tensor, prompt_len: torch.Tensor, *,
               suppress_blank: bool = True, sot_pos: int = 0,
               captured: Optional[bool] = None) -> W.DecodeResult:
        """Greedy decode of one group on ``entry``, whose cross K/V already
        holds the group's (``precompute_cross_kv(..., out=entry.cross_kv)``):
        the prefill, then one chunk at a time until every row has finished.
        On the card the chunks replay the graph; ``captured=False`` runs the
        same chunks uncaptured instead (to hold the two against each other).
        The result is copied out of the entry's buffers, so the next group
        may reuse them once it is enqueued behind this one."""
        key = entry.key
        if tuple(prompt.shape) != (key.rows, key.p_len):
            raise ValueError(f"{key}: prompt of shape {tuple(prompt.shape)}")
        if captured is None:
            captured = entry.graph is not None
        if captured and entry.graph is None:
            raise RuntimeError(f"{key}: no captured graph on {self.device}")
        dec = self.model.decoder
        st = entry.state
        no_speech = W.start_decode(dec, st, prompt, prompt_len, entry.cross_kv,
                                   suppress_blank=suppress_blank, sot_pos=sot_pos)
        for _ in range(entry.chunks):
            if captured:
                entry.graph.replay()
                entry.replays += 1
                self.graph_replays += 1
            else:
                W._decode_chunk(dec, st, entry.cross_kv)
            if bool(st.finished.all()):
                break
        return W.finish_decode(st, key.p_len, no_speech)

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays so far: each entry's
        captured launches per chunk times its replays."""
        with self._lock:
            entries = list(self._entries.values())
        return {name: sum(e.launches.get(name, 0) * e.replays for e in entries)
                for name in KERNELS}


__all__ = ["DecodeEntry", "DecodeGraphs", "GraphKey", "KERNELS"]
