"""Decode graphs: the port's counterpart of the JAX engine's exec cache.

The JAX package serves each shape as one compiled program: ``greedy_decode``
is a jitted ``lax.while_loop`` that decides on the device when to stop, its
programs sit in an exec cache (``stt_tpu/engine/engine.py:794``,
``:1390-1530``) and ``prewarm`` builds them before serving. The port keeps
one :class:`DecodeEntry` per (audio bucket, rows, prompt length, max_new,
compute type, attention policy, decoder policy, beam width, candidates,
drafted, route):

- the decode state, allocated once: at beam 1
  (:class:`~stt_tpu_torch.models.whisper.DecodeState`: self-KV cache,
  tokens, position, flags, logprob sums, the suppress and begin masks built
  once from numpy), above it
  (:class:`~stt_tpu_torch.models.whisper.BeamState`) the same for rows x
  beams, with the pool of finished candidates when the candidate count
  exceeds the beam (patience above 1), the self cache in the decoder
  policy's storage (fp8 under ``STT_SELF_KV_DTYPE=fp8``); and the cross
  K/V in the policy's
  storage (with int8 scales), for rows x beams rows, as the JAX package
  repeats the encoder output over the beams before computing it; a
  drafted entry (beam 1: the drafted greedy decode of streaming partials)
  holds a :class:`~stt_tpu_torch.models.whisper.DraftState` with the
  draft, its lengths, the accepted counts and a position per row, and
  shares the self cache and the cross K/V of the greedy entry of its
  shape, which is built first: every group rewrites both before it reads
  them, and the groups of one engine enqueue their device work one after
  another on one stream, so two entries never hold live data in them at
  once; an entry of another route
  (:class:`~stt_tpu_torch.models.whisper.Route`: timestamps, sampled,
  penalised with its n-gram size) holds the route's
  :class:`~stt_tpu_torch.models.whisper.Rules` in its state and shares
  the self cache and the cross K/V of the plain entry of its shape and
  beam width in the same way; a sampled entry owns its generator, which
  its graph registers, so every replay draws anew and a reseed reaches
  the graph;
- on the card, one ``torch.cuda.CUDAGraph`` of one chunk of
  ``FINISH_CHECK_EVERY`` steps (:func:`~stt_tpu_torch.models.whisper._decode_chunk`,
  :func:`~stt_tpu_torch.models.whisper._beam_chunk` or the drafted resume
  :func:`~stt_tpu_torch.models.whisper._drafted_chunk`) and, when ``max_new``
  is not a multiple of it, a second graph of the last ``max_new %
  FINISH_CHECK_EVERY`` steps on the same state (the tail), each captured
  after one uncaptured warm-up on a side stream (which builds the kernels,
  sets their function attributes and lets cuBLAS pick its algorithms).
  Every entry's graphs draw on one memory pool.

:meth:`DecodeGraphs.decode` runs the prefill eagerly (for a drafted entry
the verify pass over prompt + draft, with the acceptance and the commit),
then replays the chunk, and last the tail, until the loop's condition
fails (every row finished; for beams, every beam finished or every pool
full) or ``max_new`` steps ran, reading the condition on the host once per
chunk, as the uncaptured loops do (a drafted entry reads it before each
chunk: the verify pass may leave every row finished). So any positive
``max_new`` decodes exactly ``max_new`` steps at most, as the JAX loop's
bound does.
On the card serving goes through the graph and nothing else: a capture or a
replay that fails raises. On the CPU the entries hold the same buffers and
the same chunk runs uncaptured.

Kernel wrappers count their launches in Python, so a replay adds nothing
to them: each entry records the launches each of its captures made (one
chunk's, one tail's) and their replays, and
:meth:`DecodeGraphs.replayed_launches` multiplies them out.
``graph_captures`` and ``graph_replays`` play the part of the JAX engine's
``exec_cache_compiles`` and ``exec_cache_loads``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..models import whisper as W
from ..ops.kernels.cross_mm import cross_logits, cross_mix
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.mel import mel_logspec
from ..ops.kernels.xattn_decode import xattn_decode
from .spans import NO_SPANS, GroupSpans

# the kernel wrappers whose launch counts a capture records
KERNELS = {"mel_logspec": mel_logspec, "xattn_decode": xattn_decode,
           "flash_attention": flash_attention, "cross_logits": cross_logits,
           "cross_mix": cross_mix}


class GraphKey(NamedTuple):
    bucket_sec: float
    rows: int
    p_len: int
    max_new: int
    compute: torch.dtype
    policy: W.AttentionPolicy
    decoder_policy: W.DecoderPolicy
    beam: int = 1        # beams per row; 1 is the greedy decode
    candidates: int = 1  # finished hypotheses kept per row (beam_candidates)
    drafted: bool = False  # the drafted greedy decode (beam 1)
    route: W.Route = W.GREEDY  # the logit rules beyond the greedy argmax


@dataclass
class DecodeEntry:
    """The buffers, and on the card the graph, of one served shape."""

    key: GraphKey
    state: Union[W.DecodeState, W.BeamState, W.DraftState]
    cross_kv: W.CrossKV  # rows x beams rows
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[str, int] = field(default_factory=dict)  # per replay (one chunk)
    replays: int = 0
    # the last max_new % FINISH_CHECK_EVERY steps, when max_new is not a
    # multiple of it
    tail_graph: Optional["torch.cuda.CUDAGraph"] = None
    tail_launches: Dict[str, int] = field(default_factory=dict)
    tail_replays: int = 0

    @property
    def chunks(self) -> int:
        """Whole chunks of ``FINISH_CHECK_EVERY`` steps in ``max_new``."""
        return self.key.max_new // W.FINISH_CHECK_EVERY

    @property
    def tail(self) -> int:
        """Steps after the whole chunks (0 when ``max_new`` is a multiple)."""
        return self.key.max_new % W.FINISH_CHECK_EVERY

    @property
    def chunk_fn(self) -> Callable:
        """The chunk this entry replays: the drafted resume, greedy at beam
        1, else beam."""
        if self.key.drafted:
            return W._drafted_chunk
        return W._decode_chunk if self.key.beam == 1 else W._beam_chunk


class DecodeGraphs:
    """The entries of one model on one device, built on first use (or by
    the engine's ``prewarm``) and kept for the life of the cache."""

    def __init__(self, model: W.Whisper, device: torch.device, dtype: torch.dtype, *,
                 on_capture: Optional[Callable[[float], None]] = None,
                 capture: bool = True) -> None:
        self.model = model
        self.device = device
        self.dtype = dtype
        # on the card the chunks are captured unless the caller says not to
        # (a model sharded over slots on several cards runs them uncaptured)
        self.capture = capture and device.type == "cuda"
        # called with the seconds of each warm-up and capture (a metrics hook)
        self.on_capture = on_capture
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._entries: Dict[GraphKey, DecodeEntry] = {}
        self._lock = threading.Lock()
        self.graph_captures = 0
        self.graph_replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, bucket_sec: float, rows: int, p_len: int, max_new: int,
            beam: int = 1, candidates: Optional[int] = None,
            drafted: bool = False, route: W.Route = W.GREEDY) -> GraphKey:
        """The entry key; ``max_new`` is any positive bound (chunks of
        ``FINISH_CHECK_EVERY`` steps and a shorter tail cover it exactly).
        ``candidates`` defaults to the beam
        (the frozen-slot search) and is at least the beam; ``drafted``
        needs beam 1 and the greedy route, a sampled route beam 1."""
        if max_new <= 0:
            raise ValueError(f"max_new={max_new} is not positive")
        if not 1 <= int(beam) <= W.MAX_BEAM:
            raise ValueError(f"beam={beam} is not within 1..{W.MAX_BEAM}")
        beam = int(beam)
        if drafted and (beam != 1 or route != W.GREEDY):
            raise ValueError(f"a drafted entry decodes greedy at beam 1, not {beam}, {route}")
        if route.sampled and beam != 1:
            raise ValueError(f"a sampled entry decodes at beam 1, not {beam}")
        candidates = beam if candidates is None or beam == 1 else max(beam, int(candidates))
        dec = self.model.decoder
        return GraphKey(float(bucket_sec), int(rows), int(p_len), int(max_new), self.dtype,
                        dec.policy, dec.decoder_policy, beam, candidates, bool(drafted),
                        W.Route(*route))

    def entry(self, bucket_sec: float, rows: int, p_len: int, max_new: int,
              n_audio: int, beam: int = 1, candidates: Optional[int] = None,
              drafted: bool = False, route: W.Route = W.GREEDY) -> DecodeEntry:
        """The entry of this shape (``n_audio`` encoder positions at
        ``bucket_sec``), built and on the card captured on first use; a
        drafted entry, or one of another route, builds the plain entry of
        its shape and beam width first, whose self cache and cross K/V it
        shares."""
        key = self.key(bucket_sec, rows, p_len, max_new, beam, candidates, drafted, route)
        plain = (self.entry(bucket_sec, rows, p_len, max_new, n_audio, key.beam, key.candidates)
                 if drafted or key.route != W.GREEDY else None)
        with self._lock:
            found = self._entries.get(key)
            if found is None:
                found = self._build(key, n_audio, plain)
                self._entries[key] = found
        if found.cross_kv.k.shape[3] != n_audio:
            raise ValueError(f"{key}: built for {found.cross_kv.k.shape[3]} encoder "
                             f"positions, asked for {n_audio}")
        return found

    def lookup(self, bucket_sec: float, rows: int, p_len: int, max_new: int,
               beam: int = 1, candidates: Optional[int] = None,
               drafted: bool = False, route: W.Route = W.GREEDY) -> DecodeEntry:
        """The entry of this shape if it was built; KeyError otherwise."""
        key = self.key(bucket_sec, rows, p_len, max_new, beam, candidates, drafted, route)
        with self._lock:
            return self._entries[key]

    @torch.inference_mode(False)
    @torch.no_grad()
    def _build(self, key: GraphKey, n_audio: int,
               plain: Optional[DecodeEntry] = None) -> DecodeEntry:
        """Allocates the entry's buffers as normal tensors (also when the
        caller is in inference mode), so they can be updated in place
        anywhere (a drafted entry, or one of another route, takes the self
        cache and the cross K/V of ``plain``, the plain entry of its shape);
        on the card warms up and captures the chunk and the tail."""
        dec = self.model.decoder
        config = self.model.config
        cache = None if plain is None else plain.state.cache
        kv_dtype = key.decoder_policy.cache_dtype(self.dtype)
        if key.drafted:
            state = W.init_draft_state(config, key.rows, key.p_len, key.max_new, key.max_new,
                                       kv_dtype, self.device, cache=cache)
        elif key.beam == 1:
            state = W.init_decode_state(config, key.rows, key.p_len, key.max_new,
                                        kv_dtype, self.device, route=key.route, cache=cache)
        else:
            state = W.init_beam_state(config, key.rows, key.beam, key.candidates, key.p_len,
                                      key.max_new, kv_dtype, self.device, route=key.route,
                                      cache=cache)
        entry = DecodeEntry(
            key=key, state=state,
            cross_kv=plain.cross_kv if plain is not None else W.empty_cross_kv(
                dec, key.rows * key.beam, n_audio, self.dtype, self.device),
        )
        if not self.capture:
            return entry
        t0 = time.monotonic()
        if entry.chunks:
            entry.graph, entry.launches = self._capture(entry, W.FINISH_CHECK_EVERY)
        if entry.tail:
            entry.tail_graph, entry.tail_launches = self._capture(entry, entry.tail)
        self.graph_captures += 1
        if self.on_capture is not None:
            self.on_capture(time.monotonic() - t0)
        return entry

    def _capture(self, entry: DecodeEntry, n_steps: int):
        """One uncaptured warm-up of ``n_steps`` steps on a side stream,
        then the capture of the same steps: (graph, the kernel launches it
        recorded). The state the warm-up and the capture step from is
        position p_len (every row's, in a drafted entry) with an eot prompt
        (any start a chunk of steps stays inside T_max; a gated step
        launches the same kernels whether or not it writes)."""
        key, st, dec = entry.key, entry.state, self.model.decoder
        st.tokens.fill_(W.token_layout(self.model.config.n_vocab).eot)
        st.prompt_len.fill_(key.p_len)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            st.pos.fill_(key.p_len)
            entry.chunk_fn(dec, st, entry.cross_kv, n_steps)
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.pos.fill_(key.p_len)
        before = {name: fn.launches for name, fn in KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        if key.route.sampled:
            graph.register_generator_state(st.rules.generator)
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            entry.chunk_fn(dec, st, entry.cross_kv, n_steps)
        return graph, {name: fn.launches - before[name] for name, fn in KERNELS.items()}

    @torch.no_grad()
    def decode(self, entry: DecodeEntry, prompt: torch.Tensor, prompt_len: torch.Tensor, *,
               suppress_blank: bool = True, sot_pos: int = 0, length_penalty: float = 1.0,
               captured: Optional[bool] = None, draft: Optional[torch.Tensor] = None,
               draft_len: Optional[torch.Tensor] = None,
               rep_penalty: Optional[torch.Tensor] = None, temperature: float = 1.0,
               seed: int = 0, spans: GroupSpans = NO_SPANS
               ) -> Union[W.DecodeResult, W.DraftedResult]:
        """Decode of one group on ``entry``, whose cross K/V already holds
        the group's (``precompute_cross_kv(..., out=entry.cross_kv)``, over
        the beams for a beam entry: ``repeat_cross_kv``): the prefill, then
        one chunk at a time until the loop's condition fails; a beam entry
        returns each row's best beam under ``length_penalty``; a drafted
        entry verifies ``draft`` (rows, max_new), eot-padded past
        ``draft_len``, first and returns a
        :class:`~stt_tpu_torch.models.whisper.DraftedResult`. A penalised
        route takes each row's ``rep_penalty`` (rows,), a sampled one draws
        at ``temperature`` from its generator reseeded with ``seed``. On the card
        the chunks replay the graph; ``captured=False`` runs the same chunks
        uncaptured instead (to hold the two against each other). The result
        is copied out of the entry's buffers, so the next group may reuse
        them once it is enqueued behind this one. ``spans``, the group's
        record, takes ``prefill`` and each chunk's ``replay`` and ``sync``."""
        key = entry.key
        if tuple(prompt.shape) != (key.rows, key.p_len):
            raise ValueError(f"{key}: prompt of shape {tuple(prompt.shape)}")
        if captured is None:
            captured = entry.graph is not None or entry.tail_graph is not None
        if captured and ((entry.chunks and entry.graph is None)
                         or (entry.tail and entry.tail_graph is None)):
            raise RuntimeError(f"{key}: no captured graph on {self.device}")
        dec = self.model.decoder
        st = entry.state
        beam = key.beam > 1
        if key.drafted:
            if draft is None or draft_len is None:
                raise ValueError(f"{key}: a drafted entry needs draft and draft_len")
            no_speech = W.start_drafted(dec, st, prompt, prompt_len, draft, draft_len,
                                        entry.cross_kv, suppress_blank=suppress_blank,
                                        sot_pos=sot_pos)
        elif beam:
            no_speech = W.start_beam(dec, st, prompt, prompt_len, entry.cross_kv,
                                     suppress_blank=suppress_blank, sot_pos=sot_pos,
                                     rep_penalty=rep_penalty)
        else:
            no_speech = W.start_decode(dec, st, prompt, prompt_len, entry.cross_kv,
                                       suppress_blank=suppress_blank, sot_pos=sot_pos,
                                       rep_penalty=rep_penalty, temperature=temperature,
                                       seed=seed)
        spans.mark("prefill")
        for chunk in range(entry.chunks + (1 if entry.tail else 0)):
            if key.drafted:
                done = bool(st.finished.all())
                spans.mark("sync")
                if done:
                    break
            tail = chunk == entry.chunks
            if captured:
                if tail:
                    entry.tail_graph.replay()
                    entry.tail_replays += 1
                else:
                    entry.graph.replay()
                    entry.replays += 1
                self.graph_replays += 1
            else:
                entry.chunk_fn(dec, st, entry.cross_kv,
                               entry.tail if tail else W.FINISH_CHECK_EVERY)
            spans.mark("replay")
            if key.drafted:
                continue
            done = not bool(W.beam_running(st)) if beam else bool(st.finished.all())
            spans.mark("sync")
            if done:
                break
        if key.drafted:
            return W.finish_drafted(st, key.p_len, no_speech)
        if beam:
            return W.finish_beam(st, key.p_len, no_speech, length_penalty)
        return W.finish_decode(st, key.p_len, no_speech)

    def entries(self) -> List[DecodeEntry]:
        """Every entry built so far."""
        with self._lock:
            return list(self._entries.values())

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays so far: each entry's
        captured launches per chunk times its replays, and per tail times
        the tail's."""
        return {name: sum(e.launches.get(name, 0) * e.replays
                          + e.tail_launches.get(name, 0) * e.tail_replays
                          for e in self.entries())
                for name in KERNELS}


__all__ = ["DecodeEntry", "DecodeGraphs", "GraphKey", "KERNELS"]
