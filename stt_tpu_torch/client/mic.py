"""Microphone streaming client (sounddevice capture -> gRPC stream).

Parity with ``stt_client/realtime/mic.py:1-498``: a capture thread feeds a
queue drained by the chunk iterator; same session/VAD/task/profile flags;
Ctrl+C stops cleanly. ``sounddevice`` is optional — absence produces a
clear error instead of an import crash (the serving image has no audio
stack).

Run: ``python -m stt_tpu_torch.client.mic [--target ...]``.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import grpc
import yaml

from ..gen import stt_pb2
from .common import (
    StreamStats,
    TranscriptTracker,
    format_result,
    parse_decode_profile,
    parse_task,
    parse_vad_mode,
)
from .sdk import RetryConfig, StreamingClient, parse_error_code

DEFAULT_CONFIG = Path(__file__).parent / "config" / "mic.yaml"


def _load_yaml(path: Optional[str]) -> Dict[str, Any]:
    candidate = Path(path) if path else DEFAULT_CONFIG
    if not candidate.exists():
        return {}
    with open(candidate) as f:
        return yaml.safe_load(f) or {}


class MicrophoneStream:
    """Background sounddevice capture into a bounded queue."""

    def __init__(self, sample_rate: int = 16000, chunk_ms: int = 100,
                 device: Optional[int] = None, max_queue: int = 100) -> None:
        try:
            import sounddevice
        except ImportError as exc:
            raise RuntimeError(
                "microphone capture requires the 'sounddevice' package "
                "(pip install sounddevice)"
            ) from exc
        self._sd = sounddevice
        self.sample_rate = sample_rate
        self.chunk_samples = max(1, int(sample_rate * chunk_ms / 1000))
        self.device = device
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=max_queue)
        self._stream = None
        self._stopped = threading.Event()

    def __enter__(self) -> "MicrophoneStream":
        self._stream = self._sd.RawInputStream(
            samplerate=self.sample_rate,
            blocksize=self.chunk_samples,
            channels=1,
            dtype="int16",
            device=self.device,
            callback=self._on_audio,
        )
        self._stream.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def _on_audio(self, indata, frames, time_info, status) -> None:
        if status:
            print(f"[MIC] {status}", file=sys.stderr)
        try:
            self._queue.put_nowait(bytes(indata))
        except queue.Full:
            pass  # drop when the uplink is congested

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
        self._queue.put(None)

    def chunks(self) -> Iterator[bytes]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item


def run(
    target: str = "localhost:50051",
    sample_rate: int = 16000,
    chunk_ms: int = 100,
    session_id: Optional[str] = None,
    language: str = "",
    task: Optional[str] = None,
    decode_profile: Optional[str] = None,
    vad_mode: Optional[str] = None,
    vad_silence: float = 0.0,
    vad_threshold: float = 0.0,
    partial: bool = True,
    api_key: str = "",
    model_id: str = "",
    device: Optional[int] = None,
    tls_enabled: bool = False,
    tls_ca_file: Optional[str] = None,
    signed_token_secret: Optional[str] = None,
    retry_attempts: int = 3,
) -> int:
    session_id = session_id or f"mic-{uuid.uuid4().hex[:12]}"
    client = StreamingClient(
        target,
        tls_enabled=tls_enabled,
        tls_ca_file=tls_ca_file,
        signed_token_secret=signed_token_secret,
    )
    stats = StreamStats()
    try:
        attributes = {}
        if api_key:
            attributes["api_key"] = api_key
        if model_id:
            attributes["model_id"] = model_id
        if partial:
            attributes["partial"] = "true"
        request = stt_pb2.SessionRequest(
            session_id=session_id,
            attributes=attributes,
            vad_mode=parse_vad_mode(vad_mode),
            vad_silence=vad_silence,
            vad_threshold=vad_threshold,
            language_code=language,
            task=parse_task(task),
            decode_profile=parse_decode_profile(decode_profile),
        )
        metadata = client.build_signed_metadata(session_id)
        client.create_session(
            request,
            metadata=metadata or None,
            retry=RetryConfig(attempts=retry_attempts),
        )
        print(f"[MIC] session_id={session_id}; speak now (Ctrl+C to stop)")

        mic = MicrophoneStream(sample_rate, chunk_ms, device)
        stream_start = time.perf_counter()

        def audio_iter() -> Iterator[stt_pb2.AudioChunk]:
            for pcm in mic.chunks():
                stats.chunks += 1
                yield stt_pb2.AudioChunk(
                    pcm16=pcm, sample_rate=sample_rate,
                    is_final=False, session_id=session_id,
                )
            stats.chunks += 1
            yield stt_pb2.AudioChunk(
                pcm16=b"", sample_rate=sample_rate,
                is_final=True, session_id=session_id,
            )

        tracker = TranscriptTracker()
        with mic:
            try:
                for r in client.streaming_recognize(
                    audio_iter(), metadata=[("session-id", session_id)]
                ):
                    stats.responses += 1
                    recognized_at = time.perf_counter() - stream_start
                    display = tracker.display_text(r)
                    kind = "FINAL" if r.is_final else "PARTIAL"
                    print(format_result(kind, display, r, recognized_at, session_id))
            except KeyboardInterrupt:
                print("\n[MIC] stopping…")
                mic.stop()
        return 0
    except RuntimeError as exc:
        print(f"[MIC] {exc}", file=sys.stderr)
        return 2
    except grpc.RpcError as exc:
        code = parse_error_code(exc) or ""
        print(f"[MIC] RPC error {code}: {exc}", file=sys.stderr)
        return 1
    finally:
        client.close()


def main() -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, _ = pre.parse_known_args()
    defaults = _load_yaml(pre_args.config)

    parser = argparse.ArgumentParser(
        description="Stream microphone audio to the STT server", parents=[pre]
    )
    parser.add_argument("--target", default=defaults.get("target", "localhost:50051"))
    parser.add_argument("--sample-rate", type=int,
                        default=defaults.get("sample_rate", 16000))
    parser.add_argument("--chunk-ms", type=int, default=defaults.get("chunk_ms", 100))
    parser.add_argument("--session-id", default=defaults.get("session_id"))
    parser.add_argument("--language", default=defaults.get("language", ""))
    parser.add_argument("--task", default=defaults.get("task"))
    parser.add_argument("--decode-profile", default=defaults.get("decode_profile"))
    parser.add_argument("--vad-mode", default=defaults.get("vad_mode"))
    parser.add_argument("--vad-silence", type=float,
                        default=defaults.get("vad_silence", 0.0))
    parser.add_argument("--vad-threshold", type=float,
                        default=defaults.get("vad_threshold", 0.0))
    parser.add_argument("--no-partial", dest="partial", action="store_false",
                        default=defaults.get("partial", True))
    parser.add_argument("--api-key", default=defaults.get("api_key", ""))
    parser.add_argument("--model-id", default=defaults.get("model_id", ""))
    parser.add_argument("--device", type=int, default=defaults.get("device"))
    parser.add_argument("--tls", dest="tls_enabled", action="store_true",
                        default=defaults.get("tls_enabled", False))
    parser.add_argument("--tls-ca-file", default=defaults.get("tls_ca_file"))
    parser.add_argument("--signed-token-secret",
                        default=defaults.get("signed_token_secret"))
    parser.add_argument("--retry-attempts", type=int,
                        default=defaults.get("retry_attempts", 3))
    args = parser.parse_args()
    sys.exit(run(
        target=args.target,
        sample_rate=args.sample_rate,
        chunk_ms=args.chunk_ms,
        session_id=args.session_id,
        language=args.language,
        task=args.task,
        decode_profile=args.decode_profile,
        vad_mode=args.vad_mode,
        vad_silence=args.vad_silence,
        vad_threshold=args.vad_threshold,
        partial=args.partial,
        api_key=args.api_key,
        model_id=args.model_id,
        device=args.device,
        tls_enabled=args.tls_enabled,
        tls_ca_file=args.tls_ca_file,
        signed_token_secret=args.signed_token_secret,
        retry_attempts=args.retry_attempts,
    ))


if __name__ == "__main__":
    main()
