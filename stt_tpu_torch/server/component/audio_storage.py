"""Optional per-session WAV capture with retention management.

Own copy of ``stt_tpu/server/component/audio_storage.py`` for the port, which imports nothing of ``stt_tpu``.

Same capabilities as the reference component (``stt_server/backend/component/
audio_storage.py:29-275``): an opt-in manager hands each session a recorder
whose writes flow through a bounded queue to a background thread (drop-oldest
under pressure, so capture never blocks the streaming hot path), empty files
are deleted on finalize, and retention enforces max_age_days / max_files /
max_bytes oldest-first.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
import wave
from dataclasses import dataclass
from typing import Optional

from ...utils.logging import LOGGER


@dataclass(frozen=True)
class AudioStorageConfig:
    directory: str
    queue_max_chunks: Optional[int] = 256
    max_bytes: Optional[int] = None
    max_files: Optional[int] = None
    max_age_days: Optional[int] = None


class SessionAudioRecorder:
    """Queue-fed WAV writer for one session."""

    def __init__(
        self, path: str, sample_rate: int, queue_max_chunks: Optional[int]
    ) -> None:
        self.path = path
        self.sample_rate = sample_rate
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=queue_max_chunks or 0
        )
        self._dropped = 0
        self._bytes_written = 0
        self._thread = threading.Thread(
            target=self._writer_loop, name="audio-writer", daemon=True
        )
        self._thread.start()

    def append(self, pcm: bytes) -> None:
        """Enqueue a chunk; drops the oldest pending chunk when full."""
        if not pcm:
            return
        while True:
            try:
                self._queue.put_nowait(pcm)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    self._dropped += 1
                except queue.Empty:
                    pass

    def _writer_loop(self) -> None:
        wav: Optional[wave.Wave_write] = None
        try:
            while True:
                chunk = self._queue.get()
                if chunk is None:
                    break
                if wav is None:
                    os.makedirs(os.path.dirname(self.path), exist_ok=True)
                    wav = wave.open(self.path, "wb")
                    wav.setnchannels(1)
                    wav.setsampwidth(2)
                    wav.setframerate(self.sample_rate)
                wav.writeframes(chunk)
                self._bytes_written += len(chunk)
        except OSError:
            LOGGER.exception("audio capture failed for %s", self.path)
        finally:
            if wav is not None:
                wav.close()

    def finalize(self) -> Optional[str]:
        """Stop the writer; delete empty captures. Returns the kept path."""
        self._queue.put(None)
        self._thread.join(timeout=10)
        if self._dropped:
            LOGGER.warning(
                "audio capture dropped %d chunks for %s", self._dropped, self.path
            )
        if self._bytes_written == 0:
            try:
                if os.path.exists(self.path):
                    os.remove(self.path)
            except OSError:
                pass
            return None
        return self.path


class AudioStorageManager:
    """Creates recorders and enforces retention policy."""

    def __init__(self, config: AudioStorageConfig) -> None:
        self.config = config
        os.makedirs(config.directory, exist_ok=True)

    def create_recorder(
        self, session_id: str, sample_rate: int
    ) -> SessionAudioRecorder:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in session_id)
        filename = f"{int(time.time())}_{safe}.wav"
        return SessionAudioRecorder(
            os.path.join(self.config.directory, filename),
            sample_rate,
            self.config.queue_max_chunks,
        )

    def enforce_retention(self) -> int:
        """Delete files violating age/count/size caps, oldest first.
        Returns number of files removed."""
        cfg = self.config
        try:
            entries = [
                (os.path.getmtime(p), os.path.getsize(p), p)
                for p in (
                    os.path.join(cfg.directory, f)
                    for f in os.listdir(cfg.directory)
                    if f.endswith(".wav")
                )
                if os.path.isfile(p)
            ]
        except OSError:
            return 0
        entries.sort()  # oldest first
        removed = 0

        if cfg.max_age_days is not None:
            cutoff = time.time() - cfg.max_age_days * 86400
            keep = []
            for mtime, size, path in entries:
                if mtime < cutoff:
                    removed += self._remove(path)
                else:
                    keep.append((mtime, size, path))
            entries = keep

        if cfg.max_files is not None and len(entries) > cfg.max_files:
            excess = len(entries) - cfg.max_files
            for _, _, path in entries[:excess]:
                removed += self._remove(path)
            entries = entries[excess:]

        if cfg.max_bytes is not None:
            total = sum(size for _, size, _ in entries)
            idx = 0
            while total > cfg.max_bytes and idx < len(entries):
                _, size, path = entries[idx]
                removed += self._remove(path)
                total -= size
                idx += 1
        return removed

    @staticmethod
    def _remove(path: str) -> int:
        try:
            os.remove(path)
            return 1
        except OSError:
            return 0


__all__ = ["AudioStorageConfig", "AudioStorageManager", "SessionAudioRecorder"]
