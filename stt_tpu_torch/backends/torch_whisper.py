"""``torch_whisper`` ModelBackend over the port's :class:`WhisperEngine`.

Counterpart of ``stt_tpu/backends/jax_whisper.py``: a thin adapter from
the synchronous ``transcribe(audio, options)`` protocol onto the engine.
Standalone calls run synchronously on the caller's thread; a server
shares one engine and drives it through ``submit`` so many sessions
batch into one device step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..engine.engine import DecodeRequest, WhisperEngine
from .base import BackendInfo, Segment


class TorchWhisperBackend:
    def __init__(
        self,
        model_size: str,
        device: Optional[Union[str, torch.device]] = None,
        compute_type: str = "bfloat16",
        *,
        tokenizer_path: Optional[str] = None,
        engine: Optional[WhisperEngine] = None,
        **engine_kwargs: Any,
    ) -> None:
        self.engine = engine or WhisperEngine(
            model_size, device, compute_type,
            tokenizer_path=tokenizer_path, **engine_kwargs,
        )

    def transcribe(
        self, audio: np.ndarray, options: Dict[str, Any]
    ) -> Tuple[List[Segment], BackendInfo]:
        request = DecodeRequest(
            audio=np.asarray(audio, np.float32),
            language=options.get("language") or None,
            task=str(options.get("task", "transcribe")),
            options=dict(options),
            # a standalone transcribe() is a complete decode: audio past the
            # largest window needs the seek loop, which this slice refuses
            is_final=True,
        )
        out = self.engine.transcribe_sync(request)
        return out.segments, out.info

    def close(self) -> None:
        self.engine.close()


__all__ = ["TorchWhisperBackend"]
