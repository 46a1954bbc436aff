"""Realtime file client: paced streaming of an audio file with live display.

Parity with ``stt_client/realtime/file.py:1-580``: YAML config + CLI merge
(CLI wins), paced 100 ms chunking with ``--no-realtime`` burst mode,
PARTIAL/FINAL display blocks from server committed/unstable (local merge
fallback), client-side RTF metrics block, signed-token auth metadata.

Run: ``python -m stt_tpu_torch.client.realtime_file path/to.wav [--target ...]``.
"""

from __future__ import annotations

import argparse
import sys
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import grpc
import yaml

from ..gen import stt_pb2
from .common import (
    StreamStats,
    TranscriptTracker,
    chunk_stream,
    format_kv_block,
    format_result,
    load_audio,
    parse_decode_profile,
    parse_task,
    parse_vad_mode,
)
from .sdk import RetryConfig, StreamingClient, parse_error_code

DEFAULT_CONFIG = Path(__file__).parent / "config" / "file.yaml"
# bundled demo clip (parity with the reference's stt_client/assets/hello.wav,
# ref realtime/file.py:21-22) — ours is the formant-synthesized fixture
_DEFAULT_AUDIO = Path(__file__).parent / "assets" / "hello.wav"
_DEFAULT_AUDIO_DISPLAY = "stt_tpu_torch/client/assets/hello.wav"


def _load_yaml(path: Optional[str]) -> Dict[str, Any]:
    candidate = Path(path) if path else DEFAULT_CONFIG
    if not candidate.exists():
        return {}
    with open(candidate) as f:
        return yaml.safe_load(f) or {}


def run(
    path: str,
    target: str = "localhost:50051",
    chunk_ms: int = 100,
    realtime: bool = True,
    session_id: Optional[str] = None,
    language: str = "",
    task: Optional[str] = None,
    decode_profile: Optional[str] = None,
    vad_mode: Optional[str] = None,
    vad_silence: float = 0.0,
    vad_threshold: float = 0.0,
    require_token: bool = False,
    partial: bool = False,
    api_key: str = "",
    model_id: str = "",
    tls_enabled: bool = False,
    tls_ca_file: Optional[str] = None,
    signed_token_secret: Optional[str] = None,
    report_metrics: bool = True,
    retry_attempts: int = 3,
) -> int:
    session_id = session_id or f"file-{uuid.uuid4().hex[:12]}"
    client = StreamingClient(
        target,
        tls_enabled=tls_enabled,
        tls_ca_file=tls_ca_file,
        signed_token_secret=signed_token_secret,
    )
    stats = StreamStats()
    try:
        audio, sr = load_audio(path)
        audio_duration = len(audio) / sr if sr else 0.0

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
            require_token=require_token,
            language_code=language,
            task=parse_task(task),
            decode_profile=parse_decode_profile(decode_profile),
        )
        metadata = client.build_signed_metadata(session_id)
        response = client.create_session(
            request,
            metadata=metadata or None,
            retry=RetryConfig(attempts=retry_attempts),
        )
        token = response.token if response.token_required else ""
        print(
            f"[SESSION] id={session_id} profile={response.decode_profile} "
            f"language={response.language_code or 'auto'} "
            f"vad_silence={response.vad_silence:.2f} "
            f"vad_threshold={response.vad_threshold:.2f}"
        )

        stream_start = time.perf_counter()
        responses = client.streaming_recognize(
            chunk_stream(
                audio, sr, chunk_ms, session_id, token,
                realtime=realtime, stats=stats, show_progress=True,
            ),
            metadata=[("session-id", session_id)],
        )
        print(
            f"[STREAM] session_id={session_id} started "
            f"(chunk_ms={chunk_ms}, realtime={realtime})"
        )
        tracker = TranscriptTracker()
        for r in responses:
            stats.responses += 1
            recognized_at = time.perf_counter() - stream_start
            display = tracker.display_text(r)
            kind = "FINAL" if r.is_final else "PARTIAL"
            print(format_result(kind, display, r, recognized_at, session_id))
        print(f"[STREAM] session_id={session_id} completed normally")
        return 0
    except grpc.RpcError as exc:
        code = parse_error_code(exc) or ""
        print(
            f"[STREAM] session_id={session_id} RPC error {code}: {exc}",
            file=sys.stderr,
        )
        return 1
    finally:
        total_wall = time.perf_counter() - stats.started_at
        if report_metrics:
            duration = locals().get("audio_duration", 0.0)
            rtf = total_wall / duration if duration else float("inf")
            print(format_kv_block("METRIC", {
                "session_id": session_id,
                "mode": "realtime" if realtime else "burst",
                "chunks_sent": stats.chunks,
                "responses": stats.responses,
                "audio_duration_sec": duration,
                "wall_clock_sec": total_wall,
                "real_time_factor": rtf,
            }))
        client.close()


def main() -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, _ = pre.parse_known_args()
    defaults = _load_yaml(pre_args.config)

    parser = argparse.ArgumentParser(
        description="Stream an audio file to the STT server in real time",
        parents=[pre],
    )
    parser.add_argument(
        "path", nargs="?",
        default=defaults.get("audio_path") or str(_DEFAULT_AUDIO),
        help="Audio file (WAV; FLAC/OGG with soundfile); defaults to the "
             "bundled synthesized demo clip "
             f"({_DEFAULT_AUDIO_DISPLAY})",
    )
    parser.add_argument("--target", default=defaults.get("target", "localhost:50051"))
    parser.add_argument("--chunk-ms", type=int, default=defaults.get("chunk_ms", 100))
    parser.add_argument("--no-realtime", dest="realtime", action="store_false",
                        default=defaults.get("realtime", True))
    parser.add_argument("--session-id", default=defaults.get("session_id"))
    parser.add_argument("--language", default=defaults.get("language", ""))
    parser.add_argument("--task", default=defaults.get("task"))
    parser.add_argument("--decode-profile", default=defaults.get("decode_profile"))
    parser.add_argument("--vad-mode", default=defaults.get("vad_mode"))
    parser.add_argument("--vad-silence", type=float,
                        default=defaults.get("vad_silence", 0.0))
    parser.add_argument("--vad-threshold", type=float,
                        default=defaults.get("vad_threshold", 0.0))
    parser.add_argument("--require-token", action="store_true",
                        default=defaults.get("require_token", False))
    parser.add_argument("--partial", action="store_true",
                        default=defaults.get("partial", False),
                        help="Enable periodic partial decodes")
    parser.add_argument("--api-key", default=defaults.get("api_key", ""))
    parser.add_argument("--model-id", default=defaults.get("model_id", ""))
    parser.add_argument("--tls", dest="tls_enabled", action="store_true",
                        default=defaults.get("tls_enabled", False))
    parser.add_argument("--tls-ca-file", default=defaults.get("tls_ca_file"))
    parser.add_argument("--signed-token-secret",
                        default=defaults.get("signed_token_secret"))
    parser.add_argument("--no-metrics", dest="report_metrics",
                        action="store_false",
                        default=defaults.get("report_metrics", True))
    parser.add_argument("--retry-attempts", type=int,
                        default=defaults.get("retry_attempts", 3))
    args = parser.parse_args()
    sys.exit(run(
        args.path,
        target=args.target,
        chunk_ms=args.chunk_ms,
        realtime=args.realtime,
        session_id=args.session_id,
        language=args.language,
        task=args.task,
        decode_profile=args.decode_profile,
        vad_mode=args.vad_mode,
        vad_silence=args.vad_silence,
        vad_threshold=args.vad_threshold,
        require_token=args.require_token,
        partial=args.partial,
        api_key=args.api_key,
        model_id=args.model_id,
        tls_enabled=args.tls_enabled,
        tls_ca_file=args.tls_ca_file,
        signed_token_secret=args.signed_token_secret,
        report_metrics=args.report_metrics,
        retry_attempts=args.retry_attempts,
    ))


if __name__ == "__main__":
    main()
