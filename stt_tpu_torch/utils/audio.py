"""Host-side audio helpers (numpy only — device code lives in stt_tpu_torch.ops).

Own copy of ``stt_tpu/utils/audio.py`` for the port, which imports nothing of ``stt_tpu``.

These run on the control-plane hot path per 100 ms chunk, so they must be
allocation-light and never touch JAX (reference equivalents:
``stt_server/utils/audio.py:6-47``, which used torch/torchaudio; here the
resample-to-16k step is deferred to the device front end in ``ops.resample``).
"""

from __future__ import annotations

import numpy as np

_PCM16_SCALE = 1.0 / 32768.0


def pcm16_to_float32(pcm: bytes | np.ndarray) -> np.ndarray:
    """Raw little-endian PCM16 bytes -> float32 waveform in [-1, 1)."""
    if isinstance(pcm, np.ndarray):
        arr = pcm.astype(np.int16, copy=False)
    else:
        arr = np.frombuffer(pcm, dtype="<i2")
    return arr.astype(np.float32) * _PCM16_SCALE


def float32_to_pcm16(audio: np.ndarray) -> bytes:
    """Float waveform -> PCM16 bytes (clipping, round-half-away like C casts)."""
    clipped = np.clip(audio, -1.0, 1.0 - _PCM16_SCALE)
    return (clipped * 32768.0).astype("<i2").tobytes()


def chunk_duration_seconds(num_bytes: int, sample_rate: int) -> float:
    """Duration of a PCM16 mono byte buffer."""
    if sample_rate <= 0:
        return 0.0
    return (num_bytes / 2) / float(sample_rate)


def chunk_rms(pcm: bytes | np.ndarray) -> float:
    """Root-mean-square level of a PCM16 chunk in float scale [0, 1]."""
    audio = pcm16_to_float32(pcm)
    if audio.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))))


def resample_linear(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Cheap host-side linear resampler for control-plane consumers (VAD
    framing at arbitrary client rates). Decode-path resampling uses the
    polyphase device kernel in ``ops.resample`` instead."""
    if src_rate == dst_rate or audio.size == 0:
        return audio
    duration = audio.size / src_rate
    n_out = max(1, int(round(duration * dst_rate)))
    x_out = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    return np.interp(x_out, np.arange(audio.size, dtype=np.float64), audio).astype(
        np.float32
    )


__all__ = [
    "chunk_duration_seconds",
    "chunk_rms",
    "float32_to_pcm16",
    "pcm16_to_float32",
    "resample_linear",
]
