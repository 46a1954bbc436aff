"""Shared client helpers: WAV loading, transcript merge, display blocks.

Reference equivalents: ``stt_client/realtime/file.py:107-167`` (load_audio,
merge_transcript, format blocks). Audio loading uses the stdlib ``wave``
module (the serving image ships no soundfile); an optional soundfile path
handles FLAC/OGG when the library is installed.
"""

from __future__ import annotations

import time
import wave
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ..gen import stt_pb2


def load_audio(filepath: str) -> Tuple[np.ndarray, int]:
    """Load an audio file -> (int16 mono samples, sample_rate)."""
    try:
        import soundfile as sf  # optional; handles FLAC/OGG/…

        audio, sr = sf.read(filepath)
        if audio.ndim > 1:
            audio = audio[:, 0]
        return (np.asarray(audio) * 32767).astype(np.int16), int(sr)
    except ImportError:
        pass
    with wave.open(filepath, "rb") as wf:
        sr = wf.getframerate()
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        frames = wf.readframes(wf.getnframes())
    if sampwidth == 2:
        audio = np.frombuffer(frames, np.int16)
    elif sampwidth == 1:
        audio = ((np.frombuffer(frames, np.uint8).astype(np.int16) - 128) << 8)
    elif sampwidth == 4:
        audio = (np.frombuffer(frames, np.int32) >> 16).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels)[:, 0]
    return np.ascontiguousarray(audio), sr


def merge_transcript(prefix: str, next_text: str) -> str:
    """Combine partial transcripts while avoiding duplicated prefixes."""
    prefix = prefix.strip()
    next_text = next_text.strip()
    if not prefix:
        return next_text
    if not next_text:
        return prefix
    if next_text.startswith(prefix):
        return next_text
    return f"{prefix} {next_text}"


def _format_value(key: str, value: Any) -> str:
    if isinstance(value, float):
        suffix = "s" if key.endswith("_sec") else ""
        return f"{value:.2f}{suffix}"
    return str(value)


def format_kv_block(title: str, values: Dict[str, Any]) -> str:
    """Aligned key/value display block."""
    if not values:
        return f"[{title}]"
    width = max(len(label) for label in values)
    lines = [f"[{title}]"]
    for label, value in values.items():
        lines.append(f"  {label:<{width}} : {_format_value(label, value)}")
    return "\n".join(lines)


def format_result(
    kind: str,
    text: str,
    result: stt_pb2.STTResult,
    recognized_at: float,
    session_id: str,
) -> str:
    return format_kv_block(kind, {
        "session_id": session_id,
        "text": text,
        "time": f"{result.start_sec:.2f}-{result.end_sec:.2f}s",
        "language": (result.language or result.language_code or "unknown").strip(),
        "language_code": (result.language_code or "").strip(),
        "score": result.probability,
        "recognized_at": f"{recognized_at:.2f}s",
    })


@dataclass
class StreamStats:
    chunks: int = 0
    responses: int = 0
    started_at: float = field(default_factory=time.perf_counter)


class TranscriptTracker:
    """Client-side committed/unstable view, preferring server fields and
    falling back to local prefix merging (reference ``file.py:304-333``)."""

    def __init__(self) -> None:
        self.committed = ""

    def display_text(self, result: stt_pb2.STTResult) -> str:
        server_committed = (result.committed_text or "").strip()
        server_unstable = (result.unstable_text or "").strip()
        if server_committed or server_unstable:
            display = f"{server_committed} {server_unstable}".strip()
            if server_committed:
                self.committed = server_committed
            elif result.is_final:
                self.committed = display
            return display
        if result.is_final:
            self.committed = merge_transcript(self.committed, result.text)
            return self.committed
        return merge_transcript(self.committed, result.text)


def chunk_stream(
    audio: np.ndarray,
    sr: int,
    chunk_ms: int,
    session_id: str,
    session_token: str = "",
    realtime: bool = True,
    stats: Optional[StreamStats] = None,
    show_progress: bool = False,
) -> Iterator[stt_pb2.AudioChunk]:
    """Yield paced AudioChunk messages, then an empty is_final chunk."""
    samples_per_chunk = max(int(sr * (chunk_ms / 1000)), 1)
    total = len(audio)
    total_bytes = audio.nbytes
    sent = 0
    idx = 0
    while idx < total:
        end = min(idx + samples_per_chunk, total)
        pcm = audio[idx:end].tobytes()
        idx = end
        if stats is not None:
            stats.chunks += 1
        sent += len(pcm)
        if show_progress:
            print(f"\r[SEND] bytes={sent}/{total_bytes}\033[K", end="", flush=True)
        yield stt_pb2.AudioChunk(
            pcm16=pcm,
            sample_rate=sr,
            is_final=False,
            session_id=session_id,
            session_token=session_token,
        )
        if realtime:
            time.sleep(chunk_ms / 1000.0)
    if show_progress and total_bytes:
        print()
    if stats is not None:
        stats.chunks += 1
    yield stt_pb2.AudioChunk(
        pcm16=b"",
        sample_rate=sr,
        is_final=True,
        session_id=session_id,
        session_token=session_token,
    )


def parse_decode_profile(value: Optional[str]) -> int:
    if not value:
        return stt_pb2.DECODE_PROFILE_UNSPECIFIED
    return (
        stt_pb2.DECODE_PROFILE_ACCURATE
        if value.lower() == "accurate"
        else stt_pb2.DECODE_PROFILE_REALTIME
    )


def parse_task(value: Optional[str]) -> int:
    if not value:
        return stt_pb2.TASK_UNSPECIFIED
    return (
        stt_pb2.TASK_TRANSLATE
        if value.lower() in {"translate", "translation"}
        else stt_pb2.TASK_TRANSCRIBE
    )


def parse_vad_mode(value: Optional[str]) -> int:
    if value and value.lower() in {"auto", "auto_end", "auto-end", "end"}:
        return stt_pb2.VAD_AUTO_END
    return stt_pb2.VAD_CONTINUE


__all__ = [
    "StreamStats",
    "TranscriptTracker",
    "chunk_stream",
    "format_kv_block",
    "format_result",
    "load_audio",
    "merge_transcript",
    "parse_decode_profile",
    "parse_task",
    "parse_vad_mode",
]
