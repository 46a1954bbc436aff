"""WhisperEngine: one device-resident model serving many sessions.

Counterpart of ``stt_tpu/engine/engine.py`` for the serving step — greedy
at beam 1, what every streaming partial and final takes, beam search above
it (the shipped ``accurate`` profile), every decode option of the JAX
engine, and finals of any length:

- Requests enter a queue; the engine thread collects up to ``max_batch``
  of them within ``batch_window_ms``, groups compatible requests (same
  audio bucket, same prompt shape and language slot, same decode policy:
  suppress-blank, beam width and, above beam 1, patience and length
  penalty, timestamps, the n-gram size and the fallback ladder) and runs
  one batched mel -> encode -> detect -> decode step per group. Language
  detection runs on the group's rows before the beams replicate them, as
  the JAX package's ``_decode_serve`` detects before ``beam_decode``.
- The decode options, read as the JAX package reads them
  (``stt_tpu/engine/engine.py:222-366``): conditioning prompts
  (``initial_prompt``/``hotwords``, and the streaming committed transcript
  marked ``_cond_ctx``, whose length is bucketed) as ``[sot_prev] +
  tokens`` before the sot sequence, a forced ``prefix`` after it (its text
  leads the transcript), ``repetition_penalty`` and
  ``no_repeat_ngram_size`` (greedy and beam), timestamps
  (``without_timestamps=False``: segments from the timestamp grammar,
  greedy or beam), ``clip_timestamps`` (audio outside the spans zeroed),
  and the temperature-fallback ladder (``temperature`` as a list, with
  ``best_of``, ``compression_ratio_threshold``, ``log_prob_threshold`` and
  ``prompt_reset_on_temperature``): rows that fail the quality gate are
  re-decoded by sampling, re-encoded from the group's rows. Each route
  decodes on its own graph entry, captured at first use.
- Word timestamps (``word_timestamps``, ``stt_tpu/engine/engine.py:
  2634-2690``): after the ladder, the group's rows are encoded again and
  one teacher-forced pass over each row's tokens gives the last two
  decoder layers' cross-attention maps
  (:func:`~stt_tpu_torch.models.whisper.cross_attention_weights`); the
  host aligns them by DTW (:mod:`~stt_tpu_torch.models.timing`) into
  ``DecodeOutput.words``. A failed alignment is logged and leaves no
  words.
- Finals longer than the largest audio bucket run the seek loop
  (``stt_tpu/engine/engine.py:1834-1997``) on one of two side threads:
  windows of the largest bucket, each submitted through the queue so that
  it batches with other sessions' requests, conditioned on the text so
  far, the language pinned from the first window, segment and word times
  made global.
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
- The decode of each group runs on its shape's entry in the decode graph
  cache (:class:`~stt_tpu_torch.engine.graphs.DecodeGraphs`, the JAX
  engine's exec cache), a greedy entry at beam 1 and a beam entry above
  it: on the card a captured CUDA graph of the decode chunk, replayed, and
  never an eager fallback; on the CPU the same chunk uncaptured.
  :meth:`WhisperEngine.prewarm` builds the entries (and the kernels, and
  cuBLAS's choices) of the shapes and beam widths a deployment serves
  before it serves them, so nothing is captured at serving time.
- Streaming partials may be drafted (``stt_tpu/engine/engine.py:95-172``):
  a session's previous partial drafts its next one, verified in one
  teacher-forced pass on a drafted entry of the decode graphs, greedy
  resuming per row from the first mismatch (token-identical to the plain
  decode in float32). ``draft_mode`` (else ``STT_DRAFT_PARTIALS``, default
  ``adaptive``) is ``on`` (every eligible partial, and a final whose
  session holds a draft, rides the drafted decode), ``off``, or
  ``adaptive``: partials are served plain while the host measures what a
  draft would have accepted (the longest common prefix of consecutive
  token streams), and ride the drafted decode while the fleet-wide
  acceptance EMA stays above ``STT_DRAFT_ENGAGE`` (0.8; it stops below
  ``STT_DRAFT_DISENGAGE``, 0.7). Drafted and plain rows form separate
  groups; ``draft_stats`` and the metrics hook's ``record_draft_verify``
  and ``record_draft_signal`` count the acceptance.
- The device phase returns one packed int32 array per group (tokens,
  lengths, logprob sum, p(no_speech), language index and probability,
  and for a drafted group the accepted draft tokens);
  a harvester thread reads it back, detokenizes and resolves the futures,
  so the engine thread can form the next batch meanwhile. At most
  ``pipeline_depth`` groups are in flight.

Both threads are daemon threads, and :meth:`WhisperEngine.close` joins
them with timeouts and fails any request still queued, so no future is
left pending and no thread outlives the interpreter.

The model registry builds engines with the JAX engine's keywords
(``stt_tpu/engine/engine.py:947-966``): ``device_index`` picks the card
of a replica; ``metrics`` receives ``record_engine_batch`` once per group
and ``record_engine_compile`` once per decode-graph capture (the port's
compile), and, where the hook has it, ``record_engine_spans`` with each
group's span record (:mod:`~stt_tpu_torch.engine.spans`: the group's
stamps on ``time.perf_counter``, kept always, which every output of the
group also carries as ``DecodeOutput.spans``); ``pad_to_30s`` pads every
window to the 30 s bucket;
``use_pallas`` (default True) is the hand-written log-mel kernel, and
False the plain torch log-mel (``ops/mel.py``'s ``expand_wire`` and
``log_mel_raw``) on any device, the JAX engine's ``_log_mel(rows, n_mels,
use_pallas)``: the choice is the engine's, made once at build, and the
kernel's wrapper never takes the plain version by itself on the card;
``weights_path`` names an HF Whisper checkpoint directory
(``model.safetensors`` + ``config.json``, :func:`~stt_tpu_torch.models.
whisper.load_hf_safetensors`), whose config replaces ``model_size``'s and
whose vocabulary files the tokenizer then requires
(``STT_ALLOW_FALLBACK_TOKENIZER=1`` opts out); without it the weights are
drawn from ``seed``.

``max_decode_tokens`` is any positive bound (``max_new_for`` caps each
bucket's at it); the decode graphs cover one that is not a multiple of
their 8-step chunk with a captured tail.

The decoder policies (:class:`~stt_tpu_torch.models.whisper.DecoderPolicy`)
are read at engine build from the JAX package's four switches, parsed as
it parses them (``_decoder_policy``): ``STT_DECODER_WEIGHTS_DTYPE``
int8/int8_native (int8 decoder weights, under bfloat16; under float32 a
warning and the compute type, as the JAX engine does),
``STT_FUSED_QKV`` on, ``STT_SELF_KV_DTYPE`` fp8 (under bfloat16) and
``STT_PREFILL=seq``. The policy is frozen and held by the engine and its
model, so two engines of one process may differ; every decode mode, route,
captured graph and prewarm runs under it.

Beam options are read as the JAX package reads them: ``beam_size``
clamped to 1..8, ``patience`` (1..4, steps of 0.25; above 1 the pooled
search), ``length_penalty`` (0..2, steps of 0.25) and ``suppress_blank``.

``mesh_shape`` (data, model), other than 1 x 1, serves the model split over
a mesh (``stt_tpu/engine/engine.py:972-979, 1053-1063``), whose slots are
``mesh_devices`` (default: every visible card, or as many CPU slots on the
CPU, which stand in for the JAX tests' virtual devices). The JAX engine
shards only its parameters, so its data axis only replicates; the port
serves a group's rows unsplit on one tensor-parallel group, the model
slots of the mesh's first data row: q/k/v/o and fc1/fc2 of every layer
split by ``parallel/collectives.py``'s rules, each slot's products on its
own device. The engine's home device is slot (0, 0). As under JAX's mesh,
int8 decoder weights warn and are ignored, q/k/v are not fused, and a CPU
mesh turns ``use_pallas`` off. Every route runs as on one device; the
decode graphs are captured where every model slot is one device, and run
uncaptured where the slots span cards (the JAX mesh engine gives up its
executable cache likewise, ``:1429``).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..backends.base import BackendInfo, Segment
from ..device import resolve_device
from ..models import timing as T
from ..models import whisper as W
from ..models.tokenizer import load_tokenizer
from ..ops.cuda import build
from ..ops.kernels.mel import mel_logspec
from ..ops.mel import HOP_LENGTH, SAMPLE_RATE, expand_wire, log_mel_raw, normalize_log_mel
from .graphs import DecodeGraphs
from .spans import NO_SPANS, GroupSpans

LOGGER = logging.getLogger("stt_tpu_torch")

DEFAULT_AUDIO_BUCKETS_SEC = (1.0, 2.0, 5.0, 10.0, 30.0)
DEFAULT_BATCH_BUCKETS = (1, 4, 16)
# groups whose device work is enqueued but not yet harvested, unless
# STT_PIPELINE_DEPTH or the engine's pipeline_depth says otherwise
PIPELINE_DEPTH = 2
# how long close() waits for each thread to stop
CLOSE_JOIN_TIMEOUT_SEC = 120.0
# seek loops of long finals that run at once; more queue behind them
LONG_FINAL_THREADS = 2


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


def _env(name: str, default: str) -> str:
    return os.getenv(name, default).strip().lower()


def _env_draft_mode() -> str:
    """``STT_DRAFT_PARTIALS`` parsed as the JAX package parses it
    (``stt_tpu/engine/engine.py:116-137``): off/0/false/no -> ``off``,
    adaptive/auto (the default) -> ``adaptive``, on/1/true/yes/always ->
    ``on``; any other value warns and means ``adaptive``."""
    draft = _env("STT_DRAFT_PARTIALS", "adaptive")
    if draft in ("off", "0", "false", "no"):
        return "off"
    if draft in ("on", "1", "true", "yes", "always"):
        return "on"
    if draft not in ("adaptive", "auto"):
        LOGGER.warning("unrecognized STT_DRAFT_PARTIALS=%r; using 'adaptive' "
                       "(valid: on/off/adaptive)", draft)
    return "adaptive"


def _decoder_policy(dtype: torch.dtype) -> W.DecoderPolicy:
    """The decoder policy from the JAX package's four switches, each parsed
    as it parses them (``stt_tpu/models/whisper.py:353-366, 504-513,
    571-580``). int8 decoder weights under float32 compute warn and are
    ignored, as the JAX engine does (``stt_tpu/engine/engine.py:
    1068-1079``)."""
    weights = _env("STT_DECODER_WEIGHTS_DTYPE", "bf16")
    if (weights in W._W8_NAMES + W._W8_NATIVE_NAMES) and dtype != torch.bfloat16:
        LOGGER.warning("STT_DECODER_WEIGHTS_DTYPE=%s requires bfloat16 compute; "
                       "ignored (compute_type=float32)", weights)
    return W.DecoderPolicy.from_env(dtype)


def max_new_for(bucket_sec: float, max_decode_tokens: int) -> int:
    """Decode-loop bound for one audio bucket: ~7.5 tokens/sec of audio
    at 30 s = 224, rounded up to a multiple of 8 and capped at
    ``max_decode_tokens``, which may be any positive bound (100 caps the 30 s
    bucket at 100, as in the JAX engine); the decode graphs cover a bound
    off the multiple with a tail."""
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
    # the ladder rung's temperature that produced the result (0.0: the
    # primary pass)
    temperature_used: float = 0.0
    # [(start_sec, end_sec, word), ...] under the word_timestamps option
    words: List[Tuple[float, float, str]] = field(default_factory=list)
    # the group's span record (shared by every output of the group; None
    # on a long final, whose windows each had their own)
    spans: Optional[GroupSpans] = None
    # the decoded token row + prompt length that produced this output, and
    # its row in the group
    _tokens: Any = None
    _p_len: int = 0
    _n_gen: int = 0
    _row: int = 0


class _Task:
    __slots__ = ("request", "future", "cancel_event", "draft", "submitted")

    def __init__(self, request: DecodeRequest,
                 cancel_event: Optional[threading.Event]) -> None:
        self.submitted = time.perf_counter()
        self.request = request
        self.future: Future = Future()
        self.cancel_event = cancel_event
        # the session's previous-partial tokens (int32; empty when none is
        # stored) for a request routed to the drafted decode, None for the
        # plain decode; resolved by _attach_draft before grouping
        self.draft: Optional[np.ndarray] = None


_EMPTY_DRAFT = np.zeros((0,), np.int32)
DRAFT_STORE_CAP = 2048      # sessions whose last partial is kept as a draft
DRAFT_EMA_ALPHA = 0.2
DRAFT_MIN_OBS = 3           # observations before adaptive routing may engage


def _draft_option_ok(request: "DecodeRequest", mode: str = "on") -> bool:
    """Whether the drafted decode may serve ``request``
    (``stt_tpu/engine/engine.py:143-172``): a mode other than ``off``, a
    real session id to correlate ticks under, greedy (beam 1), no
    timestamps, no repetition penalty or n-gram bans and a ladder whose
    first rung is greedy, and not a window of a long final's seek loop
    (each window is other audio, and its tokens would spoil the session's
    streaming draft). Conditioning prompts and prefixes may draft."""
    if mode == "off":
        return False
    if request.options.get("_seek_window"):
        return False
    if not request.session_id or request.session_id == "unknown":
        return False
    if _beam_size_of(request) > 1:
        return False
    if not bool(request.options.get("without_timestamps", True)):
        return False
    if _ngram_of(request) or _rep_penalty_of(request) != 1.0:
        return False
    return _temperature_ladder(request.options)[0] <= 0


def _beam_size_of(request: DecodeRequest) -> int:
    """Effective beam width (``stt_tpu/engine/engine.py:222``): the
    ``accurate`` profile sets 5, realtime 1; clamped to 1..8."""
    try:
        beam = int(request.options.get("beam_size", 1) or 1)
    except (TypeError, ValueError):
        beam = 1
    return max(1, min(beam, W.MAX_BEAM))


def _clip_ranges_of(request: DecodeRequest) -> Optional[List[Tuple[float, float]]]:
    """faster_whisper ``clip_timestamps`` (``:232``): "start,end,..." seconds
    or a list of floats; only those spans of the audio are transcribed, an
    odd count running the last to the end. None when absent or default."""
    raw = request.options.get("clip_timestamps")
    if raw in (None, "", "0", 0, [0], [0.0]):
        return None
    try:
        if isinstance(raw, str):
            vals = [float(x) for x in raw.split(",") if x.strip() != ""]
        else:
            vals = [float(x) for x in raw]
    except (TypeError, ValueError):
        return None
    if not vals or vals == [0.0]:
        return None
    if len(vals) % 2 == 1:
        vals.append(float("inf"))
    return list(zip(vals[::2], vals[1::2]))


def _apply_clips(audio: np.ndarray, clips: List[Tuple[float, float]]) -> np.ndarray:
    """Zero everything outside the requested [start, end) second spans
    (``:256``)."""
    keep = np.zeros(len(audio), bool)
    for start, end in clips:
        lo = max(0, int(start * SAMPLE_RATE))
        hi = min(len(audio), int(min(end, 1e9) * SAMPLE_RATE))
        if hi > lo:
            keep[lo:hi] = True
    return np.where(keep, audio, 0.0).astype(np.float32)


def _ngram_of(request: DecodeRequest) -> int:
    """CTranslate2 ``no_repeat_ngram_size`` clamped to 0..4 (``:268``)."""
    try:
        n = int(request.options.get("no_repeat_ngram_size") or 0)
    except (TypeError, ValueError):
        n = 0
    return max(0, min(n, 4))


def _rep_penalty_of(request: DecodeRequest) -> float:
    """CTranslate2 ``repetition_penalty`` clamped to 0.1..10 (``:278``); a
    per-row tensor of the decode state, so every value shares one entry."""
    try:
        rp = float(request.options.get("repetition_penalty") or 1.0)
    except (TypeError, ValueError):
        rp = 1.0
    return max(0.1, min(rp, 10.0))


def _best_of_of(request: DecodeRequest) -> int:
    """faster_whisper ``best_of`` clamped to 1..5 (``:318``): samples per
    fallback rung above temperature 0, the best average logprob kept."""
    try:
        return max(1, min(int(request.options.get("best_of", 1) or 1), 5))
    except (TypeError, ValueError):
        return 1


def _reset_temp_of(request: DecodeRequest) -> Optional[float]:
    """faster_whisper ``prompt_reset_on_temperature`` (default 0.5,
    ``:329``): rungs above it drop the conditioning prompt; None disables."""
    try:
        raw = request.options.get("prompt_reset_on_temperature", 0.5)
        return float(raw) if raw is not None else None
    except (TypeError, ValueError):
        return 0.5


def _temperature_ladder(options: Dict[str, Any]) -> List[float]:
    """faster_whisper semantics (``:339``): a scalar temperature is a single
    rung; a list is the fallback ladder tried in order."""
    raw = options.get("temperature", 0.0)
    if isinstance(raw, (list, tuple)):
        return [float(t) for t in raw] or [0.0]
    try:
        return [float(raw)]
    except (TypeError, ValueError):
        return [0.0]


def _needs_fallback(text: str, avg_lp: float, options: Dict[str, Any]) -> bool:
    """whisper's quality gate (``:353``): a repetitive (high compression
    ratio) or low-confidence decode takes the next rung."""
    cr_threshold = options.get("compression_ratio_threshold", 2.4)
    lp_threshold = options.get("log_prob_threshold", options.get("logprob_threshold", -1.0))
    if cr_threshold is not None and W.compression_ratio(text) > float(cr_threshold):
        return True
    return lp_threshold is not None and avg_lp < float(lp_threshold)


def _decode_route(beam: int, with_ts: bool, penalised: bool, ngram_n: int) -> W.Route:
    """A group's route (``stt_tpu/engine/engine.py:_decode_best``): greedy
    with timestamps ignores the penalty and the bans; beam search applies
    all three."""
    if with_ts and beam == 1:
        return W.Route(timestamps=True)
    return W.Route(timestamps=with_ts, penalised=penalised, ngram_n=ngram_n)


def _suppress_blank_of(request: DecodeRequest) -> bool:
    """faster_whisper ``suppress_blank`` (default True): never start a
    transcript with a lone space or an immediate eot (``:289``)."""
    return bool(request.options.get("suppress_blank", True))


def _length_penalty_of(request: DecodeRequest) -> float:
    """CTranslate2's length-normalisation exponent, quantized to 0.25 and
    clamped to 0..2 (``:295``); 1.0 is the plain average logprob."""
    try:
        p = float(request.options.get("length_penalty") or 1.0)
    except (TypeError, ValueError):
        p = 1.0
    return max(0.0, min(round(p * 4) / 4, 2.0))


def _patience_of(request: DecodeRequest) -> float:
    """openai-whisper's beam patience, quantized to 0.25 and clamped to
    1..4 (``:306``); only meaningful above beam 1."""
    try:
        p = float(request.options.get("patience") or 1.0)
    except (TypeError, ValueError):
        p = 1.0
    return max(1.0, min(round(p * 4) / 4, 4.0))


def _pack_result(res: Union[W.DecodeResult, W.DraftedResult], lang_idx: torch.Tensor,
                 lang_p: torch.Tensor) -> torch.Tensor:
    """One int32 array (B, T_max + 5): [tokens | lengths |
    bitcast(sum_logprob) | bitcast(no_speech_prob) | lang_idx |
    bitcast(lang_prob)], so the host reads every output in one transfer; a
    drafted result appends one column, the accepted draft tokens."""
    def bits(x):
        return x.to(torch.float32).contiguous().view(torch.int32)[:, None]

    columns = [
        res.tokens.to(torch.int32),
        res.lengths.to(torch.int32)[:, None],
        bits(res.sum_logprob),
        bits(res.no_speech_prob),
        lang_idx.to(torch.int32)[:, None],
        bits(lang_p),
    ]
    if isinstance(res, W.DraftedResult):
        columns.append(res.n_accepted.to(torch.int32)[:, None])
    return torch.cat(columns, dim=1)


def _mel_encode(model: W.Whisper, rows: torch.Tensor, dtype: torch.dtype,
                use_pallas: bool = True) -> torch.Tensor:
    """Wire rows (B, T) -> encoder states. With ``use_pallas`` the log-mel
    runs in the hand-written kernel on the card (mu-law expansion fused
    into its load); without it, in the plain torch version on any device
    (``stt_tpu/engine/engine.py:_log_mel``)."""
    if use_pallas:
        raw = mel_logspec(rows, model.config.n_mels)
    else:
        raw = log_mel_raw(expand_wire(rows), model.config.n_mels)
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
                  suppress_blank: bool = True, lang_pos: int = 1, beam: int = 1,
                  patience: float = 1.0, length_penalty: float = 1.0,
                  route: W.Route = W.GREEDY,
                  rep_penalty: Optional[torch.Tensor] = None,
                  spans: GroupSpans = NO_SPANS) -> torch.Tensor:
    """Language detection -> decode -> packed outputs, from an encoder
    output, on the shape's entry of ``graphs`` for ``route``: greedy at
    ``beam`` 1, beam search above it (the JAX package's ``_decode_best``;
    greedy with timestamps always applies its begin mask). At beam 1 the
    cross K/V is computed once into the entry's buffers and shared by the
    detection step and the decode; above it, computed once for the B rows,
    used by the detection step, then repeated over the beams into the
    entry's B*K rows, so the language is detected and patched into the
    prompt (at ``lang_pos``, after any conditioning prompt) before the beams
    replicate it. The packed result is a new tensor, enqueued after the
    decode's last replay, so a next group of the same shape may reuse the
    entry before this one is harvested. ``spans`` takes ``detect`` and the
    decode's intervals."""
    dec = model.decoder
    if route.timestamps and beam == 1:
        suppress_blank = True
    entry = graphs.entry(bucket_sec, enc.shape[0], prompt.shape[1], max_new_tokens,
                         enc.shape[1], beam, W.beam_candidates(beam, patience), route=route)
    if beam == 1:
        cross_kv = W.precompute_cross_kv(dec, enc, out=entry.cross_kv)
    else:
        cross_kv = W.precompute_cross_kv(dec, enc)
    prompt, lang_idx, lang_p = _detect_and_patch_lang(
        model, enc, prompt, auto_mask, cross_kv, lang_pos
    )
    if beam > 1:
        W.repeat_cross_kv(cross_kv, beam, out=entry.cross_kv)
    spans.mark("detect")
    res = graphs.decode(entry, prompt, prompt_len, suppress_blank=suppress_blank,
                        sot_pos=lang_pos - 1, length_penalty=length_penalty,
                        rep_penalty=rep_penalty, spans=spans)
    return _pack_result(res, lang_idx, lang_p)


def _sample_serve(model: W.Whisper, graphs: DecodeGraphs, bucket_sec: float,
                  enc: torch.Tensor, prompt: torch.Tensor, prompt_len: torch.Tensor,
                  max_new_tokens: int, *, temperature: float, seed: int,
                  suppress_blank: bool, rep_penalty: Optional[torch.Tensor], ngram_n: int,
                  sot_pos: int) -> torch.Tensor:
    """One sampled decode of the fallback ladder -> packed outputs (the JAX
    package's ``_sample_packed``), on the shape's sampled entry: the cross
    K/V computed into its buffers, the prompt as given (its language slot
    already resolved), no detection (the language columns hold 0 and 1.0,
    unread)."""
    route = W.Route(sampled=True, penalised=rep_penalty is not None, ngram_n=ngram_n)
    entry = graphs.entry(bucket_sec, enc.shape[0], prompt.shape[1], max_new_tokens,
                         enc.shape[1], route=route)
    W.precompute_cross_kv(model.decoder, enc, out=entry.cross_kv)
    res = graphs.decode(entry, prompt, prompt_len, suppress_blank=suppress_blank,
                        sot_pos=sot_pos, rep_penalty=rep_penalty, temperature=temperature,
                        seed=seed)
    b = prompt.shape[0]
    return _pack_result(res, torch.zeros(b, dtype=torch.long, device=prompt.device),
                        torch.ones(b, device=prompt.device))


def _decode_serve_drafted(model: W.Whisper, graphs: DecodeGraphs, bucket_sec: float,
                          enc: torch.Tensor, prompt: torch.Tensor, prompt_len: torch.Tensor,
                          draft: torch.Tensor, draft_len: torch.Tensor,
                          auto_mask: torch.Tensor, max_new_tokens: int,
                          suppress_blank: bool = True, lang_pos: int = 1,
                          spans: GroupSpans = NO_SPANS) -> torch.Tensor:
    """Language detection -> drafted decode -> packed outputs, on the
    shape's drafted entry of ``graphs`` (``stt_tpu/engine/engine.py:
    558-582``): the cross K/V computed once into the entry's buffers (which
    it shares with the greedy entry of its shape), the detected language
    patched into the prompt, then the verify pass and the per-row resume.
    ``draft`` (B, max_new) is eot-padded past ``draft_len``; rows without a
    stored draft ride along with ``draft_len`` 0. Packs one extra column,
    the accepted draft tokens per row."""
    entry = graphs.entry(bucket_sec, enc.shape[0], prompt.shape[1], max_new_tokens,
                         enc.shape[1], drafted=True)
    cross_kv = W.precompute_cross_kv(model.decoder, enc, out=entry.cross_kv)
    prompt, lang_idx, lang_p = _detect_and_patch_lang(
        model, enc, prompt, auto_mask, cross_kv, lang_pos
    )
    spans.mark("detect")
    res = graphs.decode(entry, prompt, prompt_len, suppress_blank=suppress_blank,
                        sot_pos=lang_pos - 1, draft=draft, draft_len=draft_len, spans=spans)
    return _pack_result(res, lang_idx, lang_p)


def _serve_step(model: W.Whisper, graphs: DecodeGraphs, bucket_sec: float,
                rows: torch.Tensor, prompt: torch.Tensor, prompt_len: torch.Tensor,
                auto_mask: torch.Tensor, dtype: torch.dtype, max_new_tokens: int,
                suppress_blank: bool = True, beam: int = 1, patience: float = 1.0,
                length_penalty: float = 1.0, draft: Optional[torch.Tensor] = None,
                draft_len: Optional[torch.Tensor] = None, lang_pos: int = 1,
                route: W.Route = W.GREEDY,
                rep_penalty: Optional[torch.Tensor] = None,
                use_pallas: bool = True,
                spans: GroupSpans = NO_SPANS) -> torch.Tensor:
    """The whole serving step: mel + encoder, then detect + decode + pack
    (the drafted decode when ``draft`` is given); ``spans`` takes
    ``encode`` and the intervals after it."""
    enc = _mel_encode(model, rows, dtype, use_pallas)
    spans.mark("encode")
    if draft is not None:
        return _decode_serve_drafted(model, graphs, bucket_sec, enc, prompt, prompt_len,
                                     draft, draft_len, auto_mask, max_new_tokens,
                                     suppress_blank, lang_pos, spans)
    return _decode_serve(model, graphs, bucket_sec, enc, prompt, prompt_len, auto_mask,
                         max_new_tokens, suppress_blank, lang_pos, beam=beam,
                         patience=patience, length_penalty=length_penalty, route=route,
                         rep_penalty=rep_penalty, spans=spans)


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
        device_index: Optional[int] = None,
        metrics=None,
        pad_to_30s: bool = False,
        use_pallas: bool = True,
        weights_path: Optional[str] = None,
        draft_mode: Optional[str] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        mesh_devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ) -> None:
        if compute_type not in _DTYPES:
            raise ValueError(f"compute_type must be one of {sorted(_DTYPES)}, "
                             f"got {compute_type!r}")
        if int(max_decode_tokens) <= 0:
            raise ValueError(f"max_decode_tokens={max_decode_tokens} must be positive")
        self.model_size = model_size
        self.device = resolve_device(device)
        if device_index is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", int(device_index))
        self.mesh = None
        if mesh_shape is not None and tuple(mesh_shape) not in ((1,), (1, 1)):
            from ..parallel.sharding import build_mesh

            shape = tuple(int(x) for x in mesh_shape)
            if mesh_devices is None and self.device.type == "cpu":
                mesh_devices = ["cpu"] * int(np.prod(shape))
            self.mesh = build_mesh(shape, mesh_devices)
            self.device = self.mesh.devices[0]
        self.use_pallas = bool(use_pallas) and not (self.mesh is not None
                                                    and self.device.type == "cpu")
        self._metrics = metrics
        # a hook that also takes each group's span record, where it has one
        self._record_spans = getattr(metrics, "record_engine_spans", None)
        self._dtype = _DTYPES[compute_type]
        self.decoder_policy = _decoder_policy(self._dtype)
        if self.mesh is not None:
            # the split rules cover the plain weights only
            if self.decoder_policy.int8:
                LOGGER.warning("STT_DECODER_WEIGHTS_DTYPE=%s ignored under a mesh",
                               self.decoder_policy.weights)
            self.decoder_policy = dataclasses.replace(self.decoder_policy, weights="bf16",
                                                      fused_qkv=False)
        # drafted partials (stt_tpu/engine/engine.py:1008-1042): the store of
        # each session's newest partial tokens (an LRU; a final evicts), the
        # acceptance counters (live, and the adaptive mode's hypothetical
        # ones), and the engagement with its hysteresis
        env_mode = _env_draft_mode()
        self._draft_mode = (draft_mode or env_mode).strip().lower()
        if self._draft_mode not in ("on", "off", "adaptive"):
            raise ValueError(f"draft_mode must be on/off/adaptive, got {self._draft_mode!r}")
        self._drafts: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._drafts_lock = threading.Lock()
        self.draft_stats: Dict[str, Any] = {
            "rows": 0, "offered": 0, "accepted": 0,
            "hyp_offered": 0, "hyp_accepted": 0,
            "ema": 0.0, "engaged": False,
        }
        self._draft_engage = float(os.getenv("STT_DRAFT_ENGAGE", "0.8"))
        self._draft_disengage = float(os.getenv("STT_DRAFT_DISENGAGE", "0.7"))
        self._draft_ema = 0.0
        self._draft_obs = 0
        self._draft_engaged = self._draft_mode == "on"
        self.policy = W.AttentionPolicy.from_env(
            cross_kv_dtype=cross_kv_dtype, xattn_kernel=xattn_kernel,
            flash_attention=flash_attention,
        )
        t0 = time.monotonic()
        if weights_path:
            params, config = W.load_hf_safetensors(weights_path)
        else:
            config = W.get_config(model_size)
            params = W.init_params(config, seed=seed)
        self.config = config
        self.model = W.build_model(config, params, self.device, self._dtype, self.policy,
                                   self.decoder_policy)
        del params
        slots = None
        if self.mesh is not None:
            from ..parallel.collectives import shard_model_for_slots

            slots = self.mesh.model_row(0)
            shard_model_for_slots(self.model, slots)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_seconds = time.monotonic() - t0
        self.graphs = DecodeGraphs(
            self.model, self.device, self._dtype,
            on_capture=None if metrics is None else metrics.record_engine_compile,
            capture=slots is None or len(set(slots)) == 1,
        )
        self.audio_wire = _audio_wire(audio_wire)
        self.pipeline_depth = _pipeline_depth(pipeline_depth)
        # an HF checkpoint ships its tokenizer files beside the weights, and
        # real weights require a real vocabulary (stt_tpu/engine/engine.py:
        # 1080-1091)
        self.tokenizer = load_tokenizer(tokenizer_path or weights_path, config.n_vocab,
                                        require_real=bool(weights_path))
        self.layout = W.token_layout(config.n_vocab)

        if pad_to_30s:
            # every window pads to the full 30 s receptive field, as the JAX
            # engine's accuracy-parity mode does
            audio_buckets_sec = (30.0,)
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
        self._group_ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._harvest_thread: Optional[threading.Thread] = None
        self._running = False
        self._closing = False
        self._lock = threading.Lock()
        # the seek loops of long finals (_spawn_long), made at first use
        self._long_pool: Optional[ThreadPoolExecutor] = None
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

    def _window_samples(self) -> int:
        """Samples of the largest audio bucket, whole hops: a seek window."""
        win = int(self.audio_buckets_sec[-1] * SAMPLE_RATE)
        return win - win % HOP_LENGTH

    def _is_long(self, request: DecodeRequest) -> bool:
        """A final longer than the largest window runs the seek loop
        (``stt_tpu/engine/engine.py:1644-1651``); a partial keeps its
        newest window, which is what a live caption needs."""
        return request.is_final and len(request.audio) > self._window_samples()

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
        if self._long_pool is not None:
            # a seek loop sees _closing at its next wait for a window and
            # fails its final; then the pool joins
            self._long_pool.shutdown(wait=True)
            self._long_pool = None
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
        """Queue a request for the batching loop; returns a Future."""
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

    def pending(self) -> int:
        """Requests queued and not yet batched (the registry sends each task
        to the replica with the fewest)."""
        return self._queue.qsize()

    def transcribe_sync(self, request: DecodeRequest) -> DecodeOutput:
        """Run one request on the calling thread (no batching); a long
        final runs its seek loop here, its windows through the queue."""
        task = _Task(request, None)
        if self._is_long(request):
            return self._run_long(task)
        self._attach_draft(task)
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
        """Build every (audio bucket, batch bucket, beam) shape up front;
        returns the wall time in seconds (``stt_tpu/engine/engine.py:1293``).

        Each combination (``bucket_secs``, default every audio bucket, by
        ``batch_sizes``, default the smallest batch bucket, by
        ``beam_sizes``, default beam 1, each clamped to 1..8) runs one group
        of zero-audio rows through the device phase, at patience 1: that
        builds the kernels (``ops/cuda/build.py``), sets their function
        attributes, lets cuBLAS and cuDNN pick their algorithms and captures
        the shape's decode graph, so serving those shapes captures nothing.
        ``include_drafted`` adds, for every (audio bucket, batch bucket), the
        drafted entry at beam 1 (a group of empty drafts), which the boot
        prewarm builds whenever the drafted decode may serve
        (``stt_tpu/engine/engine.py:1435-1474``).
        ``include_detect`` is accepted for call sites and unused (every group
        can detect); ``parallelism`` is accepted and the shapes are built one
        after another, since captures share one device and one memory pool.
        Raises ``NotImplementedError`` for ``mode="aot"`` (ahead-of-time
        compiles have no counterpart on the card).
        """
        del include_detect, parallelism
        if mode != "execute":
            raise NotImplementedError(
                f"prewarm option mode={mode!r} is not served by stt_tpu_torch "
                f"(only 'execute'; ahead-of-time compiles have no counterpart on the card)"
            )
        beams = sorted({max(1, min(int(b), W.MAX_BEAM)) for b in (beam_sizes or (1,))})
        routes = [(beam, False) for beam in beams] + ([(1, True)] if include_drafted else [])
        t0 = time.monotonic()
        if self.device.type == "cuda":
            # log-mel and the decode step's sources, one nvcc each, side by side
            build.load_many(("mel",) + W.decode_sources(self.policy, self._dtype))
        for sec in bucket_secs or self.audio_buckets_sec:
            for rows in batch_sizes or (self.batch_buckets[0],):
                for beam, drafted in routes:
                    audio = np.zeros(int(float(sec) * SAMPLE_RATE), np.float32)
                    opts = {"beam_size": beam} if beam > 1 else {}
                    group = [_Task(DecodeRequest(audio=audio, language="en", options=opts),
                                   None) for _ in range(int(rows))]
                    for task in group:
                        task.draft = _EMPTY_DRAFT if drafted else None
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

    # -- partial-draft store ----------------------------------------------------

    def _draft_get(self, session_id: str) -> np.ndarray:
        """The session's stored draft tokens (empty when none)."""
        with self._drafts_lock:
            arr = self._drafts.get(session_id)
            if arr is None:
                return _EMPTY_DRAFT
            self._drafts.move_to_end(session_id)
            return arr

    def _draft_put(self, session_id: str, tokens: np.ndarray) -> None:
        with self._drafts_lock:
            self._drafts[session_id] = tokens
            self._drafts.move_to_end(session_id)
            while len(self._drafts) > DRAFT_STORE_CAP:
                self._drafts.popitem(last=False)

    def _draft_evict(self, session_id: str) -> None:
        with self._drafts_lock:
            self._drafts.pop(session_id, None)

    def _attach_draft(self, task: _Task) -> None:
        """Resolve one task's route (``stt_tpu/engine/engine.py:1569-1583``):
        an eligible request rides the drafted decode under ``on``, and under
        ``adaptive`` while engaged; a final only when its session holds a
        draft."""
        if task.draft is not None or not _draft_option_ok(task.request, self._draft_mode):
            return
        if self._draft_mode == "adaptive" and not self._draft_engaged:
            return
        draft = self._draft_get(task.request.session_id)
        if task.request.is_final and not len(draft):
            return
        task.draft = draft

    def _draft_observe_locked(self, offered: int, accepted: int) -> None:
        """Fold one acceptance observation (live or hypothetical) into the
        EMA and, under ``adaptive``, engage at ``STT_DRAFT_ENGAGE`` and
        disengage below ``STT_DRAFT_DISENGAGE`` once ``DRAFT_MIN_OBS``
        observations are in (``:1585-1604``). The caller holds
        ``_drafts_lock``."""
        if offered <= 0:
            return
        frac = accepted / offered
        self._draft_ema = frac if self._draft_obs == 0 else (
            (1.0 - DRAFT_EMA_ALPHA) * self._draft_ema + DRAFT_EMA_ALPHA * frac)
        self._draft_obs += 1
        if self._draft_mode == "adaptive" and self._draft_obs >= DRAFT_MIN_OBS:
            if not self._draft_engaged and self._draft_ema >= self._draft_engage:
                self._draft_engaged = True
            elif self._draft_engaged and self._draft_ema < self._draft_disengage:
                self._draft_engaged = False
        self.draft_stats["ema"] = round(self._draft_ema, 4)
        self.draft_stats["engaged"] = self._draft_engaged

    def _group_key(self, task: _Task) -> Tuple:
        """Two requests share a batch only when their audio bucket, prompt
        and conditioning lengths (the latter fixes the language slot),
        group-wide decode policy (beam, timestamps, suppress-blank, n-gram
        size, the fallback ladder with ``best_of`` and the prompt reset) and
        route (drafted or plain) match (``stt_tpu/engine/engine.py:
        1617-1642``: patience and length penalty count only above beam 1)."""
        request = task.request
        bucket = self._bucket_for(len(request.audio))
        ctx, sot_seq, prefix_ids = self._prompt_parts(request)
        beam = _beam_size_of(request)
        patience = _patience_of(request) if beam > 1 else 1.0
        len_pen = _length_penalty_of(request) if beam > 1 else 1.0
        with_ts = not bool(request.options.get("without_timestamps", True))
        fallback = (tuple(_temperature_ladder(request.options)), _best_of_of(request),
                    _reset_temp_of(request))
        return (bucket, len(ctx) + len(sot_seq) + len(prefix_ids), len(ctx), beam, with_ts,
                patience, len_pen, _suppress_blank_of(request), _ngram_of(request), fallback,
                task.draft is not None)

    def _process(self, batch: List[_Task]) -> None:
        live: List[_Task] = []
        for task in batch:
            if task.cancel_event is not None and task.cancel_event.is_set():
                task.future.cancel()
                continue
            if task.future.set_running_or_notify_cancel():
                live.append(task)
        # long finals run their seek loop on a side thread, feeding windows
        # back through the queue, so other sessions' requests keep batching
        long_tasks = [t for t in live if self._is_long(t.request)]
        live = [t for t in live if not self._is_long(t.request)]
        groups: Dict[Tuple, List[_Task]] = {}
        for task in live:
            # the route resolves once, before grouping
            self._attach_draft(task)
            groups.setdefault(self._group_key(task), []).append(task)
        max_rows = self.batch_buckets[-1]
        for group in groups.values():
            for start in range(0, len(group), max_rows):
                sub = group[start:start + max_rows]
                waited = time.perf_counter()
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
                ctx["spans"].queued(waited)
                self._harvest_q.put((sub, ctx))
        for task in long_tasks:
            self._spawn_long(task)

    def _spawn_long(self, task: _Task) -> None:
        """Run one long final's seek loop on the pool of
        ``LONG_FINAL_THREADS`` side threads (``stt_tpu/engine/engine.py:
        1702-1724``)."""
        if self._long_pool is None:
            self._long_pool = ThreadPoolExecutor(
                max_workers=LONG_FINAL_THREADS,
                thread_name_prefix=f"engine-long-{self.model_size}")

        def run() -> None:
            try:
                out = self._run_long(task)
            except Exception as exc:
                if not task.future.done():
                    task.future.set_exception(exc)
            else:
                if not task.future.done():
                    task.future.set_result(out)

        self._long_pool.submit(run)

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
        ctx, sot_seq, prefix_ids = self._prompt_parts(request)
        return ctx + sot_seq + prefix_ids

    def _prompt_parts(self, request: DecodeRequest) -> Tuple[List[int], List[int], List[int]]:
        """(conditioning prompt, sot sequence, forced prefix), the decoded
        prompt's three parts (``stt_tpu/engine/engine.py:1753``). The sot
        sequence's language slot, at ``len(ctx) + 1``, holds a placeholder
        for auto-detect rows, overwritten on the device."""
        sot_seq = W.build_prompt(
            self.config, request.language or "en", task=request.task,
            without_timestamps=bool(request.options.get("without_timestamps", True)),
        )
        return self._context_prefix(request), sot_seq, self._forced_prefix(request)

    def _forced_prefix(self, request: DecodeRequest) -> List[int]:
        """The ``prefix`` option's tokens, forced after the sot sequence
        (``:1774``); its text reappears in the transcript (``_harvest``)."""
        text = str(request.options.get("prefix") or "").strip()
        if not text:
            return []
        budget = self.config.n_text_ctx // 2 - 1
        return list(self.tokenizer.encode(" " + text)[-budget:])

    # conditioning lengths a growing context (``_cond_ctx``) truncates down
    # to, keeping its newest tokens, so a stream meets few prompt shapes;
    # below the smallest the context is dropped (``:1795``)
    _CTX_BUCKETS = (8, 16, 32, 64, 128)

    def _context_prefix(self, request: DecodeRequest) -> List[int]:
        """``[sot_prev]`` + the encoded ``initial_prompt`` (else
        ``hotwords``), truncated to half the text context (``:1797-1833``).
        Only a context the server injects (the streaming committed
        transcript, marked ``_cond_ctx``) is bucketed down to
        ``_CTX_BUCKETS``; a user's own prompt is fixed text and keeps every
        token the budget admits."""
        text = str(request.options.get("initial_prompt")
                   or request.options.get("hotwords") or "").strip()
        if not text:
            return []
        budget = self.config.n_text_ctx // 2 - 1
        ids = self.tokenizer.encode(" " + text)[-budget:]
        if len(ids) < budget and request.options.get("_cond_ctx"):
            keep = max((b for b in self._CTX_BUCKETS if len(ids) >= b), default=0)
            ids = ids[-keep:] if keep else []
        if not ids:
            return []
        return [self.layout.sot_prev] + list(ids)

    # -- long finals: the seek loop --------------------------------------------

    def _run_long(self, task: _Task) -> DecodeOutput:
        """A final longer than the largest window, transcribed window by
        window (``stt_tpu/engine/engine.py:1834-1960``, whisper's seek loop):

        - ``clip_timestamps`` are resolved over the whole audio first;
        - each window is the largest bucket's width of audio from ``seek``;
        - under ``condition_on_previous_text`` (default on) the text so far,
          after any ``initial_prompt``, conditions the next window (marked
          ``_cond_ctx``, so its length is bucketed), and a window decoded
          above ``prompt_reset_on_temperature`` drops what came before it;
        - ``prefix`` is forced on the first window only;
        - the first window's language pins the others;
        - in timestamp mode a full window's seek moves to the end of its
          last segment, so an utterance cut by the window's end is decoded
          again whole; it moves at least one second;
        - segment and word times are shifted by the window's offset;
        - the session's streaming draft is evicted at the end.
        """
        req = task.request
        audio = np.asarray(req.audio, np.float32)
        opts = dict(req.options)
        clips = _clip_ranges_of(req)
        if clips is not None:
            audio = _apply_clips(audio, clips)
            opts.pop("clip_timestamps", None)
        win = self._window_samples()
        condition = bool(opts.get("condition_on_previous_text", True))
        with_ts = not bool(opts.get("without_timestamps", True))
        reset_t = _reset_temp_of(req)
        base_prompt = str(opts.get("initial_prompt") or opts.get("hotwords") or "").strip()
        prefix_once = opts.pop("prefix", None)

        segments: List[Segment] = []
        words: List[Tuple[float, float, str]] = []
        info: Optional[BackendInfo] = None
        language = req.language
        prev_text = ""
        lp_sum = ns_sum = inference = max_temp = 0.0
        n_windows = seek = 0
        while seek < len(audio):
            if task.cancel_event is not None and task.cancel_event.is_set():
                break
            chunk = audio[seek: seek + win]
            w_opts = dict(opts)
            cond_text = (" ".join(x for x in (base_prompt, prev_text) if x).strip()
                         if condition else base_prompt)
            w_opts.pop("hotwords", None)
            if cond_text:
                w_opts["initial_prompt"] = cond_text
                if prev_text:
                    # a growing context: bucketed prompt lengths; a first
                    # window with only the user's prompt keeps its length
                    w_opts["_cond_ctx"] = True
            else:
                w_opts.pop("initial_prompt", None)
            if prefix_once is not None and seek == 0:
                w_opts["prefix"] = prefix_once
            w_opts["_seek_window"] = True
            sub = DecodeRequest(audio=chunk, language=language, task=req.task,
                                options=w_opts, is_final=False, session_id=req.session_id)
            out = self._decode_window(sub, task.cancel_event)
            if out is None:
                break
            offset = seek / SAMPLE_RATE
            dur = len(chunk) / SAMPLE_RATE
            segments.extend(Segment(x.start + offset, x.end + offset, x.text)
                            for x in out.segments)
            words.extend((ws + offset, we + offset, wt) for ws, we, wt in out.words)
            if info is None:
                info = out.info
                if not language:
                    language = out.info.language
            lp_sum += out.avg_logprob
            ns_sum += out.no_speech_prob
            inference += out.inference_sec
            max_temp = max(max_temp, out.temperature_used)
            n_windows += 1
            advance = len(chunk)
            if with_ts and out.segments and len(chunk) == win:
                last_end = out.segments[-1].end
                if 0.0 < last_end < dur:
                    advance = int(last_end * SAMPLE_RATE)
            seek += max(advance, SAMPLE_RATE)
            if condition:
                window_text = "".join(x.text for x in out.segments)
                if reset_t is not None and out.temperature_used > reset_t:
                    prev_text = window_text.strip()
                else:
                    prev_text = (prev_text + " " + window_text).strip()
                # the prompt keeps the last n_text_ctx // 2 tokens
                prev_text = prev_text[-4000:]
        if req.session_id:
            self._draft_evict(req.session_id)
        return DecodeOutput(
            segments=segments, info=info or BackendInfo(language, 1.0),
            inference_sec=inference, batch_rows=1,
            avg_logprob=lp_sum / max(1, n_windows),
            no_speech_prob=ns_sum / max(1, n_windows),
            temperature_used=max_temp, words=words,
        )

    def _decode_window(self, sub: DecodeRequest,
                       cancel_event: Optional[threading.Event]) -> Optional[DecodeOutput]:
        """One seek-loop window, submitted through the queue so that it
        batches with other sessions' requests (``stt_tpu/engine/engine.py:
        1962-1997``). None when the final was cancelled; raises when the
        engine closes, or its thread is gone, while the window waits."""
        fut = self.submit(sub, cancel_event=cancel_event)
        while True:
            try:
                return fut.result(timeout=0.5)
            except CancelledError:
                return None
            except FutureTimeout:
                if self._closing:
                    fut.cancel()
                    raise RuntimeError("engine closed during a long-audio decode") from None
                thread = self._thread
                if thread is None or not thread.is_alive():
                    if fut.done():
                        continue
                    fut.cancel()
                    raise RuntimeError(
                        "engine thread is not running during a long-audio decode") from None

    def _device_phase(self, group: List[_Task]) -> Dict[str, Any]:
        """Host prep and every device launch for one group; returns a
        context whose ``packed`` tensor is still on the device, and whose
        ``spans`` record begins with the prep."""
        spans = GroupSpans(next(self._group_ids), tuple(t.submitted for t in group))
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
            clips = _clip_ranges_of(task.request)
            if clips is not None:
                # spans in seconds of this decode window
                audio = _apply_clips(audio, clips)
            if len(audio) > bucket_samples:
                # partial-window semantics: a live caption needs the newest audio
                audio = audio[-bucket_samples:]
            rows[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
            durations.append(len(audio) / SAMPLE_RATE)

        langs: List[Optional[str]] = []
        auto_mask = np.zeros((batch_n,), np.bool_)
        prompts, prefix_texts = [], []
        lang_pos = 1
        for i, task in enumerate(group):
            lang = task.request.language
            auto_mask[i] = not lang
            langs.append(lang or None)
            ctx, sot_seq, prefix_ids = self._prompt_parts(task.request)
            prompts.append(ctx + sot_seq + prefix_ids)
            lang_pos = len(ctx) + 1  # uniform in a group (_group_key)
            prefix_texts.append(str(task.request.options.get("prefix") or "").strip()
                                if prefix_ids else "")
        p_len = len(prompts[0])
        prompt_arr = np.full((batch_n, p_len), self.layout.eot, np.int64)
        for i, p in enumerate(prompts):
            prompt_arr[i] = p
        max_new = self._max_new_for(bucket_sec)
        # one policy per group (_group_key); a group built by hand takes its
        # first request's beam options
        suppress_blank = all(_suppress_blank_of(t.request) for t in group)
        beam = _beam_size_of(group[0].request)
        patience = _patience_of(group[0].request) if beam > 1 else 1.0
        len_pen = _length_penalty_of(group[0].request) if beam > 1 else 1.0
        with_ts = any(not bool(t.request.options.get("without_timestamps", True))
                      for t in group)
        ngram = max(_ngram_of(t.request) for t in group)
        rep_arr = np.ones((batch_n,), np.float32)
        for i, task in enumerate(group):
            rep_arr[i] = _rep_penalty_of(task.request)
        # the penalised route only where some row's penalty is not 1, as the
        # JAX engine traces the penalised program only then
        penalised = not (rep_arr == 1.0).all()
        route = _decode_route(beam, with_ts, penalised, ngram)
        # a drafted group (the group key carries the route) packs each row's
        # draft, eot-padded to the bucket's max_new: one entry per shape
        # covers every draft length
        drafted = group[0].draft is not None
        if drafted:
            draft_arr = np.full((batch_n, max_new), self.layout.eot, np.int64)
            dlen_arr = np.zeros((batch_n,), np.int64)
            for i, task in enumerate(group):
                dtoks = task.draft[:max_new]
                draft_arr[i, : len(dtoks)] = dtoks
                dlen_arr[i] = len(dtoks)
        wire = _encode_wire_rows(rows, self.audio_wire)

        dev = self.device
        spans.mark("prep")
        with self._device_lock:
            spans.mark("lock_wait")
            with torch.inference_mode():
                rows_dev = torch.from_numpy(wire).to(dev)
                prompt_dev = torch.from_numpy(prompt_arr).to(dev)
                p_len_dev = torch.full((batch_n,), p_len, dtype=torch.long, device=dev)
                auto_dev = torch.from_numpy(auto_mask).to(dev)
                draft_dev = torch.from_numpy(draft_arr).to(dev) if drafted else None
                dlen_dev = torch.from_numpy(dlen_arr).to(dev) if drafted else None
                rep_dev = torch.from_numpy(rep_arr).to(dev) if route.penalised else None
                spans.mark("h2d")
                packed = _serve_step(
                    self.model, self.graphs, bucket_sec, rows_dev, prompt_dev, p_len_dev,
                    auto_dev, self._dtype, max_new, suppress_blank, beam=beam,
                    patience=patience, length_penalty=len_pen, draft=draft_dev,
                    draft_len=dlen_dev, lang_pos=lang_pos, route=route, rep_penalty=rep_dev,
                    use_pallas=self.use_pallas, spans=spans,
                )
        spans.mark("pack")
        return {
            "group": group, "packed": packed, "rows_dev": rows_dev,
            "prompt_arr": prompt_arr, "lang_pos": lang_pos, "durations": durations,
            "prefix_texts": prefix_texts, "langs": langs, "p_len": p_len,
            "with_ts": with_ts, "batch_n": batch_n, "n": n,
            "bucket_sec": bucket_sec, "max_new": max_new, "beam": beam,
            "drafted": drafted, "spans": spans,
        }

    def _row_output(self, ctx: Dict[str, Any], arr: np.ndarray, i: int, lang: str,
                    lang_p: float, p_len: int) -> DecodeOutput:
        """Row ``i`` of a packed result (a prompt of ``p_len`` tokens) as an
        output (``stt_tpu/engine/engine.py:2314-2379``): the timestamp
        segments, clamped to the row's audio (those starting past it or
        without text dropped), else one segment of the text, a forced
        prefix's text leading it; no segment under whisper's no-speech rule
        (p(no_speech) high and the decode low-confidence)."""
        task = ctx["group"][i]
        duration = ctx["durations"][i]
        t_max = arr.shape[1] - 5
        n_gen = max(0, int(arr[i, t_max]) - p_len)
        gen_tokens = arr[i, p_len : p_len + n_gen]
        avg_lp = float(arr[i, t_max + 1 : t_max + 2].view(np.float32)[0] / max(1, n_gen))
        no_speech_p = float(arr[i, t_max + 2 : t_max + 3].view(np.float32)[0])
        if ctx["with_ts"]:
            segments = []
            for start, end, toks in W.split_timestamp_segments(gen_tokens, self.config,
                                                               duration):
                if start >= duration:
                    continue
                seg_text = self.tokenizer.decode(toks)
                if not seg_text.strip():
                    continue
                segments.append(Segment(max(0.0, min(start, duration)),
                                        max(0.0, min(end, duration)), seg_text))
        else:
            text = self.tokenizer.decode(gen_tokens)
            if ctx["prefix_texts"][i]:
                text = " " + ctx["prefix_texts"][i] + text
            segments = [Segment(0.0, duration, text)] if text.strip() else []
        opts = task.request.options
        ns_threshold = opts.get("no_speech_threshold", 0.6)
        lp_threshold = opts.get("log_prob_threshold", opts.get("logprob_threshold", -1.0))
        if (ns_threshold is not None and no_speech_p > float(ns_threshold)
                and lp_threshold is not None and avg_lp < float(lp_threshold)):
            segments = []
        return DecodeOutput(
            segments=segments, info=BackendInfo(lang, lang_p),
            batch_rows=ctx["n"], avg_logprob=avg_lp, no_speech_prob=no_speech_p,
            _tokens=arr[i, :t_max].astype(np.int32), _p_len=p_len, _n_gen=n_gen, _row=i,
        )

    def _harvest(self, ctx: Dict[str, Any]) -> List[DecodeOutput]:
        """Blocking readback + host postprocessing for one group, then the
        fallback ladder where the options carry one. The group's record
        takes the harvest's end and goes with every output."""
        group, spans = ctx["group"], ctx["spans"]
        arr = ctx["packed"].cpu().numpy()  # the ONE device->host transfer
        if ctx["drafted"]:
            self._count_draft_verify(group, arr[: len(group), -1], ctx["max_new"])
            arr = arr[:, :-1]
        t_max = arr.shape[1] - 5
        langs, lang_ps = list(ctx["langs"]), [1.0] * len(group)
        for i in range(len(group)):
            if langs[i] is None:
                idx = min(max(int(arr[i, t_max + 3]), 0), len(W.WHISPER_LANG_CODES) - 1)
                langs[i] = W.WHISPER_LANG_CODES[idx]
                lang_ps[i] = float(arr[i, t_max + 4 : t_max + 5].view(np.float32)[0])
        outputs = [self._row_output(ctx, arr, i, langs[i], lang_ps[i], ctx["p_len"])
                   for i in range(len(group))]
        ladder = _temperature_ladder(group[0].request.options)
        if len(ladder) > 1 and not ctx["with_ts"]:
            self._fallback(ctx, outputs, langs, lang_ps, ladder)
        wt_rows = [i for i, t in enumerate(group)
                   if t.request.options.get("word_timestamps") and outputs[i].segments
                   and outputs[i]._n_gen > 0]
        if wt_rows:
            try:
                self._word_timestamp_pass(ctx, outputs, wt_rows)
            except Exception:
                LOGGER.exception("word-timestamp alignment failed; results carry no words")
        self._refresh_drafts(group, outputs, ctx["max_new"])
        spans.close()
        elapsed = spans.inference_sec
        if self._metrics is not None:
            self._metrics.record_engine_batch(ctx["n"], ctx["batch_n"], elapsed)
        if self._record_spans is not None:
            self._record_spans(spans)
        for out in outputs:
            out.inference_sec = elapsed
            out.spans = spans
        return outputs

    def _fallback(self, ctx: Dict[str, Any], outputs: List[DecodeOutput], langs: List[str],
                  lang_ps: List[float], ladder: List[float]) -> None:
        """The temperature-fallback ladder (``stt_tpu/engine/engine.py:
        2419-2530``), in place on ``outputs``: the rows that fail the quality
        gate (every row when the first rung is above 0) are re-decoded by
        sampling at each next rung from the group's rows, encoded anew, with
        the resolved language in the prompt's slot and, above
        ``prompt_reset_on_temperature``, the bare sot sequence; ``best_of``
        samples a rung (one at temperature 0), seeded ``rung * 131 + sample
        + 1``, the best average logprob kept per row, until no row fails.
        Each decode holds the device lock, as a group's device phase does."""
        group = ctx["group"]
        if ladder[0] > 0:
            failing, rungs = list(range(len(group))), ladder
        else:
            failing = [i for i, out in enumerate(outputs) if _needs_fallback(
                " ".join(s.text for s in out.segments), out.avg_logprob,
                group[i].request.options)]
            rungs = ladder[1:]
        if not failing:
            return
        dev, batch_n, p_len = self.device, ctx["batch_n"], ctx["p_len"]
        bucket_sec, max_new = ctx["bucket_sec"], ctx["max_new"]
        prompt_arr = ctx["prompt_arr"].copy()
        for i, lang in enumerate(langs):
            prompt_arr[i, ctx["lang_pos"]] = (self.layout.lang_begin
                                              + W.WHISPER_LANG_CODES.index(lang))
        bare = None
        bare_prompts = [
            W.build_prompt(self.config, langs[i], task=t.request.task,
                           without_timestamps=bool(
                               t.request.options.get("without_timestamps", True)))
            for i, t in enumerate(group)
        ]
        if len(bare_prompts[0]) < p_len:
            bare = np.full((batch_n, len(bare_prompts[0])), self.layout.eot, np.int64)
            for i, bp in enumerate(bare_prompts):
                bare[i] = bp
        rep_arr = np.ones((batch_n,), np.float32)
        for i, t in enumerate(group):
            rep_arr[i] = _rep_penalty_of(t.request)
        ngram = max(_ngram_of(t.request) for t in group)
        reset_t, best_of = _reset_temp_of(group[0].request), _best_of_of(group[0].request)
        with self._device_lock, torch.inference_mode():
            enc = _mel_encode(self.model, ctx["rows_dev"], self._dtype, self.use_pallas)
        for rung_idx, temp in enumerate(rungs):
            use_bare = bare is not None and reset_t is not None and temp > reset_t
            prompt = bare if use_bare else prompt_arr
            pl = prompt.shape[1]
            candidates = []
            for sample_idx in range(best_of if temp > 0 else 1):
                with self._device_lock, torch.inference_mode():
                    packed = _sample_serve(
                        self.model, self.graphs, bucket_sec, enc,
                        torch.from_numpy(prompt).to(dev),
                        torch.full((batch_n,), pl, dtype=torch.long, device=dev), max_new,
                        temperature=temp, seed=rung_idx * 131 + sample_idx + 1,
                        suppress_blank=_suppress_blank_of(group[0].request),
                        rep_penalty=(None if (rep_arr == 1.0).all()
                                     else torch.from_numpy(rep_arr).to(dev)),
                        ngram_n=ngram, sot_pos=0 if use_bare else ctx["lang_pos"] - 1,
                    )
                arr = packed.cpu().numpy()
                candidates.append([self._row_output(ctx, arr, i, langs[i], lang_ps[i], pl)
                                   for i in failing])
            still = []
            for slot, i in enumerate(failing):
                best = max((cand[slot] for cand in candidates), key=lambda o: o.avg_logprob)
                best.temperature_used = float(temp)
                outputs[i] = best
                if _needs_fallback(" ".join(s.text for s in best.segments), best.avg_logprob,
                                   group[i].request.options):
                    still.append(i)
            failing = still
            if not failing:
                break

    def _word_timestamp_pass(self, ctx: Dict[str, Any], outputs: List[DecodeOutput],
                             wt_rows: List[int]) -> None:
        """Word times for rows ``wt_rows`` of a harvested group
        (``stt_tpu/engine/engine.py:2634-2690``), in place on ``outputs``:
        the group's rows encoded again, one teacher-forced pass over each
        row's prompt and generated tokens (eot-padded to the group's prompt
        length plus the bucket's ``max_new``) for the last two decoder
        layers' cross-attention maps, then DTW on the host. A row decoded
        without timestamps has its one segment narrowed to its words'
        extent. The device work holds the device lock, as a group's device
        phase does."""
        t_seq = ctx["p_len"] + ctx["max_new"]
        tokens2d = np.full((ctx["batch_n"], t_seq), self.layout.eot, np.int64)
        for i in wt_rows:
            out = outputs[i]
            row = out._tokens[: out._p_len + out._n_gen][:t_seq]
            tokens2d[i, : len(row)] = row
        with self._device_lock, torch.inference_mode():
            enc = _mel_encode(self.model, ctx["rows_dev"], self._dtype, self.use_pallas)
            maps = W.cross_attention_weights(
                self.model, torch.from_numpy(tokens2d).to(self.device), enc, n_align_layers=2)
            picked = torch.tensor(wt_rows, device=self.device)
            k, _, h, t, ta = maps.shape
            # (K, R, H, T, Ta) -> (R, K*H, T, Ta): the rows' heads, layer-major
            flat = maps.index_select(1, picked).transpose(0, 1).reshape(
                len(wt_rows), k * h, t, ta).cpu().numpy()
            del maps, enc
        for r, i in enumerate(wt_rows):
            out = outputs[i]
            gen = out._tokens[out._p_len: out._p_len + out._n_gen]
            positions = [out._p_len + j for j, tok in enumerate(gen)
                         if int(tok) < self.layout.eot and out._p_len + j < t_seq]
            ids = [int(tokens2d[i, pos]) for pos in positions]
            words = T.word_alignments(flat[r], ids, positions, self.tokenizer,
                                      ctx["durations"][i])
            out.words = [(w.start, w.end, w.word) for w in words]
            if out.words and not ctx["with_ts"] and out.segments:
                seg = out.segments[0]
                out.segments = [Segment(out.words[0][0], max(out.words[-1][1], out.words[0][0]),
                                        seg.text)] + out.segments[1:]

    def _count_draft_verify(self, group: List[_Task], accepted: np.ndarray,
                            max_new: int) -> None:
        """A drafted group's acceptance (``stt_tpu/engine/engine.py:
        2383-2407``): rows with a non-empty draft, draft tokens offered and
        accepted go to ``draft_stats``, the EMA and the metrics hook. The
        harvester and ``transcribe_sync`` callers may harvest at once, so
        the read-modify-write holds the lock."""
        offered = sum(min(len(t.draft), max_new) for t in group)
        rows_with = sum(1 for t in group if len(t.draft) > 0)
        n_acc = int(accepted.sum())
        with self._drafts_lock:
            st = self.draft_stats
            st["rows"] += rows_with
            st["offered"] += offered
            st["accepted"] += n_acc
            self._draft_observe_locked(offered, n_acc)
        if self._metrics is not None:
            self._metrics.record_draft_verify(rows_with, offered, n_acc)

    def _refresh_drafts(self, group: List[_Task], outputs: List[DecodeOutput],
                        max_new: int) -> None:
        """The draft store after a group (``stt_tpu/engine/engine.py:
        2560-2616``): a final evicts its session's draft; an eligible
        partial stores its generated tokens, whatever its route, and under
        ``adaptive`` a plain-routed one first measures what its stored draft
        would have accepted (the longest common prefix, the drafted decode's
        rule), folded into the EMA once per group."""
        hyp_cap = hyp_lcp = 0
        for task, out in zip(group, outputs):
            sid = task.request.session_id
            if not sid:
                continue
            if task.request.is_final:
                self._draft_evict(sid)
                continue
            if task.draft is None and not _draft_option_ok(task.request, self._draft_mode):
                continue
            gen = np.asarray(out._tokens[out._p_len: out._p_len + out._n_gen], np.int32)
            if task.draft is None and self._draft_mode == "adaptive":
                prev = self._draft_get(sid)
                cap = min(len(prev), max_new)
                if cap > 0:
                    n = min(cap, len(gen))
                    neq = np.nonzero(prev[:n] != gen[:n])[0]
                    hyp_cap += cap
                    hyp_lcp += int(neq[0]) if len(neq) else n
            self._draft_put(sid, gen)
        if hyp_cap > 0:
            with self._drafts_lock:
                st = self.draft_stats
                st["hyp_offered"] += hyp_cap
                st["hyp_accepted"] += hyp_lcp
                self._draft_observe_locked(hyp_cap, hyp_lcp)
                ema, engaged = self._draft_ema, self._draft_engaged
            if self._metrics is not None:
                self._metrics.record_draft_signal(hyp_cap, hyp_lcp, ema, engaged)


__all__ = [
    "DEFAULT_AUDIO_BUCKETS_SEC",
    "DEFAULT_BATCH_BUCKETS",
    "DecodeOutput",
    "DecodeRequest",
    "WhisperEngine",
    "max_new_for",
]
