"""Log-mel spectrogram front end as plain PyTorch.

Counterpart of ``stt_tpu/ops/mel.py``: Whisper's front end (openai-whisper
``audio.py``) — Hann-windowed STFT (n_fft 400, hop 160, centred reflect
padding, last frame dropped), power spectrum, Slaney-normalised mel
filterbank, ``log10`` with a -8 dynamic-range clamp and ``(x + 4) / 4``.

The STFT is one matmul of the reflect-padded frames against a windowed
real/imaginary DFT basis, as in the JAX package. The filterbank and the
basis are own numpy copies of the JAX package's, built the same way, so
both packages project with identical constants. The serving path reaches
this arithmetic through the hand-written kernel in
``stt_tpu_torch/ops/kernels/mel.py``; the functions here are its plain
reference and the CPU path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES_PER_CHUNK = SAMPLE_RATE * CHUNK_SECONDS  # 480_000
N_FRAMES_PER_CHUNK = N_SAMPLES_PER_CHUNK // HOP_LENGTH  # 3000


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE):
    """Slaney-scale, slaney-normalized mel filter matrix (n_mels, n_fft//2+1).

    Reimplements librosa.filters.mel defaults (htk=False, norm="slaney"),
    which is what Whisper's shipped ``mel_filters.npz`` contains.
    """

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # linear below 1 kHz, log above (Slaney)
        mel = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3.0)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney normalization: constant energy per channel
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.astype(np.float32)


@lru_cache(maxsize=2)
def _dft_basis(n_fft: int = N_FFT):
    """Windowed real-DFT basis: (n_fft, 2*(n_fft//2+1)) = [cos | -sin].

    The Hann window is folded into the basis so framing -> spectrum is a
    single matmul.
    """
    n_bins = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann, matches torch
    k = np.arange(n_bins).reshape(1, -1)
    n = np.arange(n_fft).reshape(-1, 1)
    angle = 2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (window.reshape(-1, 1) * basis).astype(np.float32)


def expand_wire(rows: torch.Tensor) -> torch.Tensor:
    """Audio rows on the engine's wire -> float32 waveform in [-1, 1].

    uint8 rows are 8-bit mu-law (the inverse of the engine's encoding
    table: ``256**|y| == 2**(8|y|)``), int16 rows are PCM16, float32 rows
    pass through. Same arithmetic as ``stt_tpu/engine/engine.py:397-402``.
    """
    if rows.dtype == torch.uint8:
        y = rows.to(torch.float32) * (1.0 / 127.5) - 1.0
        return torch.sign(y) * (torch.exp2(8.0 * torch.abs(y)) - 1.0) * (1.0 / 255.0)
    if rows.dtype == torch.int16:
        return rows.to(torch.float32) * (1.0 / 32768.0)
    if rows.dtype == torch.float32:
        return rows
    raise TypeError(f"audio rows must be uint8, int16 or float32, got {rows.dtype}")


def check_audio_length(n_samples: int) -> None:
    """The frame grid needs whole hops and room for the reflect padding."""
    if n_samples % HOP_LENGTH != 0:
        raise ValueError(
            f"audio length {n_samples} not a multiple of hop={HOP_LENGTH}"
        )
    if n_samples <= N_FFT // 2:
        raise ValueError(
            f"audio length {n_samples} too short for reflect padding of "
            f"{N_FFT // 2} samples"
        )


def log_mel_raw(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """float32 waveform (B, T) -> un-normalised ``log10`` mel power
    (B, n_mels, T // hop): everything before the dynamic-range clamp."""
    b, t = audio.shape
    check_audio_length(t)
    n_frames = t // HOP_LENGTH
    pad = N_FFT // 2
    padded = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    # centred STFT emits n_frames + 1 frames; Whisper drops the last
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # (B, F, n_fft)
    basis = torch.from_numpy(_dft_basis(N_FFT)).to(audio.device)
    spec = torch.matmul(frames, basis)  # (B, F, 2 * bins)
    n_bins = N_FFT // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel_t = torch.from_numpy(mel_filterbank(n_mels, N_FFT).T.copy()).to(audio.device)
    mel_power = torch.matmul(power, mel_t)  # (B, F, n_mels)
    return torch.log10(torch.clamp_min(mel_power, 1e-10)).transpose(1, 2)


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-row ``max - 8`` dynamic-range clamp, then ``(x + 4) / 4``."""
    row_max = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, row_max - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """float32 waveform (T,) or (B, T) -> log-mel features (..., n_mels,
    T // hop). T must be a multiple of ``HOP_LENGTH`` (the engine always
    supplies bucketed lengths)."""
    if audio.ndim == 1:
        return log_mel_spectrogram(audio[None], n_mels)[0]
    return normalize_log_mel(log_mel_raw(audio.to(torch.float32), n_mels))


__all__ = [
    "CHUNK_SECONDS",
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES_PER_CHUNK",
    "N_SAMPLES_PER_CHUNK",
    "SAMPLE_RATE",
    "expand_wire",
    "log_mel_raw",
    "log_mel_spectrogram",
    "mel_filterbank",
    "normalize_log_mel",
]
