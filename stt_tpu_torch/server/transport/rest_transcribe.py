"""One-shot REST transcription: ``POST /v1/audio/transcriptions``.

Own copy of ``stt_tpu/server/transport/rest_transcribe.py`` for the port, which imports nothing of ``stt_tpu``.

Beyond-reference convenience surface (the reference exposes batch
transcription only through the gRPC batch client,
``stt_client/batch/file.py``): upload a WAV, get the
transcript back in one HTTP round trip, with OpenAI-audio-style request
fields (``file``, ``language``, ``response_format``) so existing REST
integrations port over directly.

The endpoint is a thin shim: it creates a session through the full
CreateSession gauntlet (auth, rate limits, per-identity caps) and feeds
the audio through the same ``StreamOrchestrator`` state machine the
gRPC/WS transports use, so every server-side limit and metric applies
unchanged. Decode semantics match the batch client: unpaced chunks, the
last chunk ``is_final``, ``accurate`` profile by default.

Request encodings:
- ``multipart/form-data`` with a ``file`` part (WAV) plus optional text
  fields, or
- a raw WAV body (any other content type) with options as query params.

Options: ``language`` (BCP-47 code), ``task`` (``transcribe`` |
``translate``), ``decode_profile``, ``model_id``, ``response_format``
(``json`` default | ``text`` | ``verbose_json`` | ``srt`` | ``vtt``).
An ``Authorization: Bearer <key>`` header is forwarded as the session
``api_key`` attribute.
"""

from __future__ import annotations

import base64
import email.parser
import email.policy
import io
import json
import re
import uuid
import wave
from typing import Any, Dict, Iterator, List, Optional, Tuple

import grpc
import numpy as np

from ...errors import ERROR_HTTP_STATUS_MAP, ErrorCode, http_payload_for
from ...gen import stt_pb2
from ...utils.logging import LOGGER
from ...utils.subtitles import cues_from_results, render_srt, render_vtt
from .ws_server import _peer_for_ws

_CHUNK_MS = 500
_ERR_RE = re.compile(r"ERR\d{4}")

_TASK_ALIASES = {
    "transcribe": stt_pb2.TASK_TRANSCRIBE,
    "translate": stt_pb2.TASK_TRANSLATE,
}
_PROFILE_ALIASES = {
    "realtime": stt_pb2.DECODE_PROFILE_REALTIME,
    "accurate": stt_pb2.DECODE_PROFILE_ACCURATE,
}
RESPONSE_FORMATS = ("json", "text", "verbose_json", "srt", "vtt")


class RestAbort(RuntimeError):
    """Raised by :class:`RestContext` when a layer aborts the request."""

    def __init__(self, status: grpc.StatusCode, details: str) -> None:
        super().__init__(details)
        self.status = status
        self.details = details


class RestContext:
    """grpc.ServicerContext stand-in for the synchronous REST flow.

    Same minimal surface as the WS bridge's context
    (``ws_server.WebSocketContext``): metadata, peer, liveness,
    disconnect callbacks, trailing metadata, abort.
    """

    # unbounded trailing metadata: no gRPC wire limit applies, so the
    # orchestrator emits full (uncapped) word-timestamp coverage
    inprocess_trailing = True

    def __init__(
        self, peer: str, metadata: Optional[List[Tuple[str, str]]] = None
    ) -> None:
        self._peer_label = peer
        self._invocation_md = list(metadata or [])
        self._on_close: List[Any] = []
        self._open = True
        self.trailing_metadata = None

    def peer(self) -> str:
        return self._peer_label

    def is_active(self) -> bool:
        return self._open

    def invocation_metadata(self):
        return self._invocation_md

    def set_trailing_metadata(self, metadata):
        self.trailing_metadata = metadata

    def add_callback(self, callback):
        self._on_close.append(callback)
        return True

    def abort(self, code, details):
        raise RestAbort(code, details)

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        for hook in self._on_close:
            try:
                hook()
            except Exception:
                LOGGER.exception("REST disconnect callback failed")


def parse_wav_bytes(data: bytes) -> Tuple[bytes, int]:
    """16-bit PCM WAV → (mono pcm16 bytes, sample_rate).

    Stereo takes the left channel (same convention as the CLI clients'
    loader). Raises ``ValueError`` for non-WAV or non-16-bit payloads.
    """
    try:
        with wave.open(io.BytesIO(data), "rb") as wf:
            channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            rate = wf.getframerate()
            frames = wf.readframes(wf.getnframes())
    except (wave.Error, EOFError) as exc:
        raise ValueError(f"not a readable WAV file: {exc}") from exc
    if sampwidth != 2:
        raise ValueError("only 16-bit PCM WAV is supported")
    if rate <= 0:
        raise ValueError("WAV header has no sample rate")
    if channels > 1:
        pcm = np.frombuffer(frames, dtype=np.int16)
        usable = (len(pcm) // channels) * channels
        frames = np.ascontiguousarray(
            pcm[:usable].reshape(-1, channels)[:, 0]
        ).tobytes()
    return frames, rate


def _multipart_boundary(content_type: str) -> bytes:
    for param in content_type.split(";")[1:]:
        key, _, val = param.strip().partition("=")
        if key.strip().lower() == "boundary":
            return val.strip().strip('"').encode("utf-8", "replace")
    return b""


# form fields where repeated parts are meaningful (accumulated
# comma-joined); every other repeated field is last-wins
_MULTI_VALUE_FIELDS = frozenset(
    {"timestamp_granularities", "timestamp_granularities[]"}
)


def parse_multipart(
    content_type: str, body: bytes
) -> Tuple[Dict[str, str], Optional[bytes]]:
    """multipart/form-data → ({text fields}, file bytes or None).

    Splits the raw bytes on the boundary directly; only each part's tiny
    header block goes through the email parser. Routing the WHOLE body
    through ``email.BytesParser`` (the obvious one-liner) surrogate-
    escapes the binary payload into str and back — ~5x transient memory
    per request, which on a threaded server defeats the 413 body cap's
    purpose of bounding per-request RAM.
    """
    fields: Dict[str, str] = {}
    file_bytes: Optional[bytes] = None
    boundary = _multipart_boundary(content_type)
    if not boundary:
        return fields, None
    header_parser = email.parser.BytesParser(policy=email.policy.default)
    for segment in body.split(b"--" + boundary)[1:]:
        if segment[:2] == b"--":
            break  # closing delimiter
        if segment[:2] == b"\r\n":
            segment = segment[2:]
        elif segment[:1] == b"\n":
            segment = segment[1:]
        head, sep, payload = segment.partition(b"\r\n\r\n")
        if not sep:
            head, sep, payload = segment.partition(b"\n\n")
            if not sep:
                continue
        # the CRLF before the next delimiter belongs to the delimiter
        if payload[-2:] == b"\r\n":
            payload = payload[:-2]
        elif payload[-1:] == b"\n":
            payload = payload[:-1]
        part = header_parser.parsebytes(head + b"\r\n\r\n")
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        cte = str(part.get("content-transfer-encoding", "")).strip().lower()
        if cte == "base64":
            try:
                payload = base64.b64decode(payload, validate=False)
            except Exception:
                pass
        if name == "file":
            file_bytes = payload
        else:
            value = payload.decode("utf-8", "replace").strip()
            name = str(name)
            if name in fields and name in _MULTI_VALUE_FIELDS:
                # repeated form fields (OpenAI sends one
                # `timestamp_granularities[]` part per value) accumulate
                # comma-joined; consumers split on comma. Only the known
                # multi-valued keys join — a client repeating e.g. `task`
                # keeps last-wins instead of producing "translate,translate"
                # (ADVICE r4 low)
                fields[name] = f"{fields[name]},{value}"
            else:
                fields[name] = value
    return fields, file_bytes


def _chunks(
    pcm: bytes,
    sample_rate: int,
    session_id: str,
    session_token: str,
) -> Iterator[stt_pb2.AudioChunk]:
    """Unpaced chunk stream; the last chunk carries ``is_final``."""
    bytes_per_chunk = max(int(sample_rate * (_CHUNK_MS / 1000.0)) * 2, 2)
    total = len(pcm)
    if total == 0:
        yield stt_pb2.AudioChunk(
            session_id=session_id,
            session_token=session_token,
            sample_rate=sample_rate,
            is_final=True,
        )
        return
    idx = 0
    while idx < total:
        end = min(idx + bytes_per_chunk, total)
        yield stt_pb2.AudioChunk(
            pcm16=pcm[idx:end],
            sample_rate=sample_rate,
            is_final=end >= total,
            session_id=session_id,
            session_token=session_token,
        )
        idx = end


def _abort_response(details: str) -> Tuple[int, Dict[str, str]]:
    """Abort details → (http status, error payload), one ERR-code parse."""
    match = _ERR_RE.search(details or "")
    if match:
        try:
            code = ErrorCode(match.group(0))
            return (
                ERROR_HTTP_STATUS_MAP.get(code, 400),
                http_payload_for(code, details),
            )
        except ValueError:
            pass
    return 400, {"code": "aborted", "message": details or "request aborted"}


def _bad_request(message: str) -> Tuple[int, str, Any]:
    return 400, "application/json", {
        "code": "invalid_request", "message": message,
    }


GRANULARITIES = ("word", "segment")


def parse_granularities(
    query: Dict[str, List[str]], fields: Dict[str, str]
) -> Optional[set]:
    """``timestamp_granularities`` request values → set, or None if unset.

    Accepts the OpenAI field in both spellings (``timestamp_granularities``
    and the form-array ``timestamp_granularities[]``), repeated or
    comma-joined, from query params or form fields. Raises ``ValueError``
    on entries outside ``GRANULARITIES``.
    """
    raw: List[str] = []
    for key in ("timestamp_granularities", "timestamp_granularities[]"):
        raw.extend((query or {}).get(key) or [])
        value = fields.get(key)
        if value:
            raw.append(value)
    values = {
        v.strip().lower()
        for item in raw
        for v in item.split(",")
        if v.strip()
    }
    bad = values - set(GRANULARITIES)
    if bad:
        raise ValueError(
            "timestamp_granularities entries must be "
            + " or ".join(f"'{g}'" for g in GRANULARITIES)
        )
    return values or None


def words_from_trailing(trailing) -> List[Dict[str, Any]]:
    """``stt-word-timestamps`` trailing metadata → OpenAI-style words.

    The proto carries segment times only; word-level times (the
    ``word_timestamps`` decode option) ride the trailing metadata as
    compact JSON ``[[start, end, text], ...]`` (see
    ``orchestrator._finalize_stream``). Absent or unparseable metadata
    yields an empty list — words are additive, never a failure.
    """
    for key, value in tuple(trailing or ()):
        if key != "stt-word-timestamps":
            continue
        try:
            return [
                {"word": text, "start": start, "end": end}
                for start, end, text in json.loads(value)
            ]
        except (ValueError, TypeError):
            LOGGER.warning("unparseable stt-word-timestamps metadata")
            return []
    return []


def format_response(
    results: List, fmt: str, duration_sec: float, task: str,
    words: Optional[List[Dict[str, Any]]] = None,
    granularities: Optional[set] = None,
) -> Tuple[str, Any]:
    """Final STTResults → (content_type, payload) for ``response_format``.

    ``granularities`` (from ``timestamp_granularities``) shapes
    ``verbose_json`` the OpenAI way: when set, ``segments`` appears only
    if it names ``segment`` and ``words`` appears (possibly empty — the
    decode profile must enable ``word_timestamps`` to populate it) only
    if it names ``word``. When unset, segments always appear and words
    are additive when available.
    """
    finals = [r for r in results if r.is_final]
    text = " ".join(r.text.strip() for r in finals if r.text.strip())
    if fmt == "text":
        return "text/plain; charset=utf-8", text + ("\n" if text else "")
    if fmt == "srt":
        return "text/plain; charset=utf-8", render_srt(
            cues_from_results(finals)
        )
    if fmt == "vtt":
        return "text/vtt; charset=utf-8", render_vtt(
            cues_from_results(finals)
        )
    if fmt == "verbose_json":
        language = next(
            (r.language_code for r in finals if r.language_code), ""
        )
        payload = {
            "task": task or "transcribe",
            "language": language,
            "duration": round(duration_sec, 3),
            "text": text,
        }
        if granularities is None or "segment" in granularities:
            payload["segments"] = [
                {
                    "id": i,
                    "start": r.start_sec,
                    "end": r.end_sec,
                    "text": r.text,
                }
                for i, r in enumerate(finals)
            ]
        if (
            granularities is not None and "word" in granularities
        ) or (granularities is None and words):
            payload["words"] = words or []
        return "application/json", payload
    return "application/json", {"text": text}


def handle_transcription(
    runtime,
    query: Dict[str, List[str]],
    headers,
    body: bytes,
    client_ip: str,
    bearer_token: str,
    force_task: str = "",
) -> Tuple[int, str, Any]:
    """Full request flow; returns (status, content_type, payload).

    ``force_task`` pins the Whisper task for alias routes
    (``/v1/audio/translations`` forces ``translate``, matching the
    OpenAI audio API's split endpoints); a request field naming a
    DIFFERENT task is rejected rather than silently overridden.
    """
    content_type = str(
        (headers.get("content-type") if headers else "") or ""
    )
    fields: Dict[str, str] = {
        key: values[0] for key, values in (query or {}).items() if values
    }
    if content_type.lower().startswith("multipart/form-data"):
        try:
            form_fields, file_bytes = parse_multipart(content_type, body)
        except Exception as exc:
            return _bad_request(f"unparseable multipart body: {exc}")
        fields.update(form_fields)
        if file_bytes is None:
            return _bad_request("multipart body has no 'file' part")
        audio_bytes = file_bytes
    else:
        audio_bytes = body
    if not audio_bytes:
        return _bad_request("empty audio payload")

    fmt = (fields.get("response_format") or "json").strip().lower()
    if fmt not in RESPONSE_FORMATS:
        return _bad_request(
            f"response_format must be one of {', '.join(RESPONSE_FORMATS)}"
        )
    try:
        granularities = parse_granularities(query, fields)
    except ValueError as exc:
        return _bad_request(str(exc))
    if granularities is not None and fmt != "verbose_json":
        # match the OpenAI API: granularities only shape verbose_json;
        # accepting-and-ignoring them elsewhere hid client mistakes
        # (ADVICE r4 low)
        return _bad_request(
            "timestamp_granularities requires response_format=verbose_json"
        )
    task_name = (fields.get("task") or "").strip().lower()
    if task_name and task_name not in _TASK_ALIASES:
        return _bad_request("task must be 'transcribe' or 'translate'")
    if force_task:
        if task_name and task_name != force_task:
            return _bad_request(
                f"this endpoint always runs task '{force_task}'; "
                f"use /v1/audio/transcriptions for task '{task_name}'"
            )
        task_name = force_task
    profile_name = (
        (fields.get("decode_profile") or "accurate").strip().lower()
    )
    if profile_name not in _PROFILE_ALIASES:
        return _bad_request(
            f"decode_profile must be one of {', '.join(_PROFILE_ALIASES)}"
        )

    try:
        pcm, sample_rate = parse_wav_bytes(audio_bytes)
    except ValueError as exc:
        return _bad_request(str(exc))
    duration_sec = len(pcm) / 2.0 / sample_rate

    attributes = {"upload_mode": "batch"}
    if bearer_token:
        attributes["api_key"] = bearer_token
    model_id = (fields.get("model_id") or "").strip()
    if model_id:
        attributes["model_id"] = model_id

    # signed_token auth signs "session_id:ts", so the client must be able
    # to choose the session_id it signed (same as gRPC/WS); anonymous
    # uploads get a generated one
    session_id = (
        (fields.get("session_id") or "").strip()
        or f"rest-{uuid.uuid4().hex[:12]}"
    )
    request = stt_pb2.SessionRequest(
        session_id=session_id,
        attributes=attributes,
        vad_mode=stt_pb2.VAD_CONTINUE,
        vad_threshold=0.0,  # endpointing is pointless for one-shot uploads
        language_code=(fields.get("language") or "").strip(),
        task=_TASK_ALIASES.get(task_name, stt_pb2.TASK_UNSPECIFIED),
        decode_profile=_PROFILE_ALIASES[profile_name],
    )
    # the signed-token auth gauntlet reads invocation metadata
    # (authorization / x-stt-auth + x-stt-auth-ts) — forward the HTTP
    # headers so REST requests authenticate exactly like gRPC/WS ones
    metadata = (
        [(str(k).lower(), str(v)) for k, v in headers.items()]
        if headers
        else []
    )
    context = RestContext(peer=_peer_for_ws(client_ip), metadata=metadata)
    try:
        response = runtime.create_session_handler.handle(request, context)
        token = response.token if response.token_required else ""
        results = list(
            runtime.stream_orchestrator.run(
                _chunks(pcm, sample_rate, session_id, token), context
            )
        )
    except RestAbort as exc:
        status, payload = _abort_response(exc.details)
        return status, "application/json", payload
    finally:
        context.close()
    content_type, payload = format_response(
        results, fmt, duration_sec, task_name,
        words=words_from_trailing(context.trailing_metadata),
        granularities=granularities,
    )
    return 200, content_type, payload


__all__ = [
    "RESPONSE_FORMATS",
    "RestAbort",
    "RestContext",
    "format_response",
    "handle_transcription",
    "parse_granularities",
    "parse_multipart",
    "parse_wav_bytes",
    "words_from_trailing",
]
