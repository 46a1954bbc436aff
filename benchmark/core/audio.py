"""Synthetic speech-band audio from the seed: a copy of the port's bench
``synth_audio`` (a 220 Hz tone at 0.1 plus Gaussian noise at 0.05), as one
base signal that every session reads at its own offset, so each session
has its own phase of the tone and its own stretch of the noise."""

from __future__ import annotations

from typing import Dict

import numpy as np

SAMPLE_RATE = 16000


def base_signal(seed: int, seconds: float, params: Dict) -> np.ndarray:
    n = int(seconds * SAMPLE_RATE)
    rng = np.random.default_rng([int(seed), 1])
    t = np.arange(n) / SAMPLE_RATE
    tone = float(params.get("tone_amp", 0.1)) * np.sin(
        2 * np.pi * float(params.get("tone_hz", 220.0)) * t)
    noise = float(params.get("noise_amp", 0.05)) * rng.normal(0.0, 1.0, n)
    return (tone + noise).astype(np.float32)


def lognormal_grid(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """``n`` lengths at the lognormal's quantiles (i + 0.5) / n, clipped to
    [lo, hi]: every seed gets this same set, in its own order."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def uniform_grid(n: int, lo: float, hi: float) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n
