"""Deterministic audio-derived fake backend for hermetic tests and demos.

Own copy of ``stt_tpu/backends/fake.py`` for the port, which imports nothing of ``stt_tpu``.

The reference test suite monkeypatches hand-rolled fakes into the
orchestrator (``tests/test_stream_orchestrator.py:66-119``); SURVEY §4 calls
for a first-class fake backend so integration tests never need weights or a
TPU. This one maps audio *content* to text deterministically: the window is
cut into fixed 400 ms cells, each active cell (RMS above a floor) yields a
pseudo-word derived from the cell's quantized energy envelope. Two decodes
over overlapping windows therefore agree on their shared prefix — exactly the
property the committed/unstable transcript logic needs to be exercised
realistically.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np

from .base import BackendInfo, Segment

_CELL_SEC = 0.4
_RMS_FLOOR = 0.005
_CONS = "bdfgklmnprstvz"
_VOW = "aeiou"


def _cell_word(fingerprint: bytes) -> str:
    digest = hashlib.sha1(fingerprint).digest()
    n_syll = 2 + digest[0] % 2
    word = []
    for i in range(n_syll):
        word.append(_CONS[digest[1 + 2 * i] % len(_CONS)])
        word.append(_VOW[digest[2 + 2 * i] % len(_VOW)])
    return "".join(word)


class FakeBackend:
    """Deterministic content-addressed transcription (no model, no device)."""

    def __init__(
        self, model_size: str = "fake", device: str = "cpu", compute_type: str = "float32"
    ) -> None:
        self.model_size = model_size
        self.device = device
        self.compute_type = compute_type

    def transcribe(
        self, audio: np.ndarray, options: Dict[str, Any]
    ) -> Tuple[List[Segment], BackendInfo]:
        sr = 16000
        cell = int(_CELL_SEC * sr)
        audio = np.asarray(audio, dtype=np.float32)
        language = str(options.get("language") or "en")

        words: List[Tuple[float, float, str]] = []
        for i in range(len(audio) // cell):
            chunk = audio[i * cell : (i + 1) * cell]
            rms = float(np.sqrt(np.mean(chunk**2)))
            if rms < _RMS_FLOOR:
                continue
            # quantized energy envelope: stable across float jitter and
            # identical for the same audio region in different windows
            envelope = np.sqrt(
                np.mean(chunk.reshape(8, -1) ** 2, axis=1)
            )
            fingerprint = np.round(envelope * 100).astype(np.int32).tobytes()
            words.append(
                (i * _CELL_SEC, (i + 1) * _CELL_SEC, _cell_word(fingerprint))
            )

        if not words:
            return [], BackendInfo(language, 1.0)
        text = " " + " ".join(w for _, _, w in words)
        segment = Segment(words[0][0], words[-1][1], text)
        return [segment], BackendInfo(language, 1.0)


__all__ = ["FakeBackend"]
