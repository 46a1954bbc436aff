"""ModelBackend contract shared by all inference implementations.

Own copy of ``stt_tpu/backends/base.py``: a backend is constructed with
(model_size, device, compute_type) and exposes
``transcribe(audio, options) -> (segments, info)`` over float32 16 kHz
waveforms (reference protocol ``stt_server/model/backends/base.py:7-35``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Protocol, Tuple, runtime_checkable

import numpy as np


class Segment(NamedTuple):
    start: float
    end: float
    text: str


class BackendInfo(NamedTuple):
    language: str
    language_probability: float


@runtime_checkable
class ModelBackend(Protocol):
    def __init__(self, model_size: str, device: str, compute_type: str) -> None: ...

    def transcribe(
        self, audio: np.ndarray, options: Dict[str, Any]
    ) -> Tuple[List[Segment], BackendInfo]: ...


__all__ = ["BackendInfo", "ModelBackend", "Segment"]
