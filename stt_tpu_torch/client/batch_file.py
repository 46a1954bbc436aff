"""Batch file client: single-session unpaced upload, final on last chunk.

Parity with ``stt_client/batch/file.py:1-594``: chunked-but-unpaced upload
where the LAST audio chunk carries ``is_final=True`` (no trailing empty
chunk), defaults to the ``accurate`` decode profile and ``upload_mode=
batch`` so the server applies the batch rate-limit lane.

Run: ``python -m stt_tpu_torch.client.batch_file path/to.wav [--target ...]``.
"""

from __future__ import annotations

import argparse
import sys
import time
import uuid
from pathlib import Path
from typing import Iterator, Optional

import grpc
import numpy as np

from ..gen import stt_pb2
from ..utils.subtitles import cues_from_results, render_srt, render_vtt
from .common import (
    StreamStats,
    TranscriptTracker,
    format_kv_block,
    format_result,
    load_audio,
    parse_decode_profile,
    parse_task,
)
from .sdk import RetryConfig, StreamingClient, parse_error_code


def chunked_iter(
    audio: np.ndarray,
    sr: int,
    chunk_ms: int,
    session_id: str,
    session_token: str,
    stats: StreamStats,
) -> Iterator[stt_pb2.AudioChunk]:
    """Unpaced chunks; the last one is marked final."""
    samples_per_chunk = max(int(sr * (chunk_ms / 1000)), 1)
    total = len(audio)
    idx = 0
    while idx < total:
        end = min(idx + samples_per_chunk, total)
        pcm = audio[idx:end].tobytes()
        is_last = end >= total
        stats.chunks += 1
        yield stt_pb2.AudioChunk(
            pcm16=pcm,
            sample_rate=sr,
            is_final=is_last,
            session_id=session_id,
            session_token=session_token,
        )
        idx = end


def run(
    path: str,
    target: str = "localhost:50051",
    chunk_ms: int = 500,
    session_id: Optional[str] = None,
    language: str = "",
    task: Optional[str] = None,
    decode_profile: str = "accurate",
    api_key: str = "",
    model_id: str = "",
    tls_enabled: bool = False,
    tls_ca_file: Optional[str] = None,
    signed_token_secret: Optional[str] = None,
    report_metrics: bool = True,
    retry_attempts: int = 3,
    srt_path: Optional[str] = None,
    vtt_path: Optional[str] = None,
) -> int:
    session_id = session_id or f"batch-{uuid.uuid4().hex[:12]}"
    client = StreamingClient(
        target,
        tls_enabled=tls_enabled,
        tls_ca_file=tls_ca_file,
        signed_token_secret=signed_token_secret,
    )
    stats = StreamStats()
    audio_duration = 0.0
    try:
        audio, sr = load_audio(path)
        audio_duration = len(audio) / sr if sr else 0.0

        attributes = {"upload_mode": "batch"}
        if api_key:
            attributes["api_key"] = api_key
        if model_id:
            attributes["model_id"] = model_id
        request = stt_pb2.SessionRequest(
            session_id=session_id,
            attributes=attributes,
            vad_mode=stt_pb2.VAD_CONTINUE,
            vad_threshold=0.0,  # VAD endpointing is pointless for batch
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

        stream_start = time.perf_counter()
        responses = client.streaming_recognize(
            chunked_iter(audio, sr, chunk_ms, session_id, token, stats),
            metadata=[("session-id", session_id)],
        )
        tracker = TranscriptTracker()
        finals = []
        for r in responses:
            stats.responses += 1
            recognized_at = time.perf_counter() - stream_start
            display = tracker.display_text(r)
            kind = "FINAL" if r.is_final else "PARTIAL"
            if r.is_final:
                finals.append(r)
            print(format_result(kind, display, r, recognized_at, session_id))
        if srt_path or vtt_path:
            cues = cues_from_results(finals)
            if srt_path:
                Path(srt_path).write_text(render_srt(cues), encoding="utf-8")
                print(f"[BATCH] wrote {len(cues)} cues to {srt_path}")
            if vtt_path:
                Path(vtt_path).write_text(render_vtt(cues), encoding="utf-8")
                print(f"[BATCH] wrote {len(cues)} cues to {vtt_path}")
        return 0
    except grpc.RpcError as exc:
        code = parse_error_code(exc) or ""
        print(
            f"[BATCH] session_id={session_id} RPC error {code}: {exc}",
            file=sys.stderr,
        )
        return 1
    finally:
        total_wall = time.perf_counter() - stats.started_at
        if report_metrics:
            rtf = total_wall / audio_duration if audio_duration else float("inf")
            print(format_kv_block("METRIC", {
                "session_id": session_id,
                "mode": "batch",
                "chunks_sent": stats.chunks,
                "responses": stats.responses,
                "audio_duration_sec": audio_duration,
                "wall_clock_sec": total_wall,
                "real_time_factor": rtf,
            }))
        client.close()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Upload an audio file for batch transcription"
    )
    parser.add_argument(
        "path", nargs="?",
        default=str(Path(__file__).parent / "assets" / "hello.wav"),
        help="Audio file; defaults to the bundled synthesized demo clip",
    )
    parser.add_argument("--target", default="localhost:50051")
    parser.add_argument("--chunk-ms", type=int, default=500)
    parser.add_argument("--session-id", default=None)
    parser.add_argument("--language", default="")
    parser.add_argument("--task", default=None)
    parser.add_argument("--decode-profile", default="accurate")
    parser.add_argument("--api-key", default="")
    parser.add_argument("--model-id", default="")
    parser.add_argument("--tls", dest="tls_enabled", action="store_true")
    parser.add_argument("--tls-ca-file", default=None)
    parser.add_argument("--signed-token-secret", default=None)
    parser.add_argument("--no-metrics", dest="report_metrics", action="store_false")
    parser.add_argument("--retry-attempts", type=int, default=3)
    parser.add_argument("--srt", dest="srt_path", default=None,
                        help="write final segments as a SubRip .srt file")
    parser.add_argument("--vtt", dest="vtt_path", default=None,
                        help="write final segments as a WebVTT .vtt file")
    args = parser.parse_args()
    sys.exit(run(
        args.path,
        target=args.target,
        chunk_ms=args.chunk_ms,
        session_id=args.session_id,
        language=args.language,
        task=args.task,
        decode_profile=args.decode_profile,
        api_key=args.api_key,
        model_id=args.model_id,
        tls_enabled=args.tls_enabled,
        tls_ca_file=args.tls_ca_file,
        signed_token_secret=args.signed_token_secret,
        report_metrics=args.report_metrics,
        retry_attempts=args.retry_attempts,
        srt_path=args.srt_path,
        vtt_path=args.vtt_path,
    ))


if __name__ == "__main__":
    main()
