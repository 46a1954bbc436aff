"""Voice-activity scoring: adaptive-noise-floor DSP VAD.

Own copy of ``stt_tpu/ops/vad.py`` for the port, which imports nothing of ``stt_tpu``.

The reference gates endpointing on Silero-VAD probabilities over 512-sample
(32 ms @ 16 kHz) frames (reference: ``stt_server/backend/component/vad_gate.py:
326-394``). Silero weights cannot be fetched in a zero-egress build, so this
module provides a deterministic statistical VAD with the same interface
contract: per-frame speech probability in [0, 1], thresholded upstream by the
session's ``vad_threshold``.

Per frame it combines three cues:
- SNR against an adaptive noise floor (minimum-statistics tracking),
- speech-band (~80-4000 Hz) energy concentration,
- spectral flatness (harmonic speech is peaky; broadband noise is flat),

then applies fast-attack/slow-release smoothing.

The scoring math is written against an injected array namespace (``numpy`` or
``jax.numpy``): the host control plane scores single sessions without device
round-trips, while the engine scores *all* active sessions in one jitted
batched call — both provably identical (tested).

Frame spectra use a matmul DFT basis (see ops.mel) so the JAX path stays
MXU-friendly and pallas-portable.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np

VAD_FRAME_SAMPLES = 512
VAD_SAMPLE_RATE = 16000
_N_BINS = VAD_FRAME_SAMPLES // 2 + 1
_EPS = 1e-10


@dataclass(frozen=True)
class VadParams:
    """Tuning constants for the DSP VAD (defaults calibrated for 0.5 thresh)."""

    snr_midpoint_db: float = 6.0       # SNR giving 0.5 on the SNR sigmoid
    snr_slope: float = 0.35
    band_midpoint: float = 0.55        # speech-band ratio giving 0.5
    band_slope: float = 8.0
    flatness_weight: float = 0.5       # how much flatness can attenuate
    noise_floor_rise: float = 1.02     # per-frame multiplicative creep upward
    noise_floor_init: float = 1e-6     # initial energy floor (~-60 dBFS)
    attack: float = 0.7                # new-prob weight when rising
    release: float = 0.3               # new-prob weight when falling
    band_low_hz: float = 80.0
    band_high_hz: float = 4000.0


class VadState(NamedTuple):
    """Per-session streaming state (all scalars; stackable for batching)."""

    noise_floor: np.ndarray  # smoothed noise energy estimate
    prob: np.ndarray         # last smoothed probability
    frames_seen: np.ndarray  # int32 frame counter


def init_state(xp=np, params: VadParams = VadParams()) -> VadState:
    return VadState(
        noise_floor=xp.asarray(params.noise_floor_init, dtype=xp.float32),
        prob=xp.asarray(0.0, dtype=xp.float32),
        frames_seen=xp.asarray(0, dtype=xp.int32),
    )


@lru_cache(maxsize=2)
def _vad_dft_basis() -> np.ndarray:
    """(512, 2*257) windowed real-DFT basis, shared by numpy and JAX paths."""
    window = np.hanning(VAD_FRAME_SAMPLES + 1)[:-1]
    k = np.arange(_N_BINS).reshape(1, -1)
    n = np.arange(VAD_FRAME_SAMPLES).reshape(-1, 1)
    angle = 2.0 * np.pi * n * k / VAD_FRAME_SAMPLES
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (window.reshape(-1, 1) * basis).astype(np.float32)


@lru_cache(maxsize=2)
def _band_mask(low_hz: float, high_hz: float) -> np.ndarray:
    freqs = np.fft.rfftfreq(VAD_FRAME_SAMPLES, d=1.0 / VAD_SAMPLE_RATE)
    return ((freqs >= low_hz) & (freqs <= high_hz)).astype(np.float32)


def _sigmoid(xp, x):
    return 1.0 / (1.0 + xp.exp(-x))


def vad_step(xp, frames, state: VadState, params: VadParams = VadParams()):
    """Score ``frames`` (..., F, 512) sequentially, carrying streaming state.

    Returns (probs (..., F), new_state). ``xp`` is numpy or jax.numpy; with
    jax.numpy the loop over F unrolls at trace time (F is small: a 100 ms
    chunk is 3 frames).
    """
    basis = xp.asarray(_vad_dft_basis())
    band = xp.asarray(_band_mask(params.band_low_hz, params.band_high_hz))

    frames = frames.astype(xp.float32)
    spec = frames @ basis  # (..., F, 2*bins)
    power = spec[..., :_N_BINS] ** 2 + spec[..., _N_BINS:] ** 2

    energy = xp.mean(frames**2, axis=-1)  # (..., F)
    total_p = xp.sum(power, axis=-1) + _EPS
    band_ratio = xp.sum(power * band, axis=-1) / total_p

    # spectral flatness over the speech band
    band_bins = xp.sum(band) + _EPS
    log_gm = xp.sum(xp.log(power + _EPS) * band, axis=-1) / band_bins
    am = xp.sum(power * band, axis=-1) / band_bins
    flatness = xp.exp(log_gm) / (am + _EPS)  # (..., F) in (0, 1]

    n_frames = frames.shape[-2]
    noise_floor = state.noise_floor
    prob = state.prob
    frames_seen = state.frames_seen
    probs = []
    for i in range(n_frames):
        e = energy[..., i]
        # minimum statistics: drop instantly to quieter frames, creep upward
        noise_floor = xp.where(
            e < noise_floor, e, noise_floor * params.noise_floor_rise
        )
        noise_floor = xp.maximum(noise_floor, params.noise_floor_init)

        snr_db = 10.0 * (xp.log10(e + _EPS) - xp.log10(noise_floor + _EPS))
        p_snr = _sigmoid(xp, params.snr_slope * (snr_db - params.snr_midpoint_db))
        p_band = _sigmoid(
            xp, params.band_slope * (band_ratio[..., i] - params.band_midpoint)
        )
        p_tone = 1.0 - params.flatness_weight * xp.clip(
            flatness[..., i] * 4.0, 0.0, 1.0
        )
        raw = p_snr * (0.25 + 0.75 * p_band) * p_tone

        alpha = xp.where(raw > prob, params.attack, params.release)
        prob = alpha * raw + (1.0 - alpha) * prob
        probs.append(prob)
        frames_seen = frames_seen + 1

    stacked = xp.stack(probs, axis=-1)
    return stacked, VadState(noise_floor, prob, frames_seen)


__all__ = [
    "VAD_FRAME_SAMPLES",
    "VAD_SAMPLE_RATE",
    "VadParams",
    "VadState",
    "init_state",
    "vad_step",
]
