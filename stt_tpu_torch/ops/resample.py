"""Polyphase audio resampling in PyTorch.

Counterpart of ``stt_tpu/ops/resample.py:26-74``: the same filter design
(``_design``: a Kaiser-windowed sinc from scipy's ``firwin``, beta 5.0, 10
taps per zero crossing, scaled by ``up``) and the same upfirdn: zero-stuff
by ``up``, pad ``(half, half + down)``, correlate with the FIR at stride
``down`` (one ``conv1d``), cut to ``ceil(T * up / down)`` samples. The JAX
package expresses the zero-stuffing as the convolution's ``lhs_dilation``;
here it is explicit. The model registry calls :func:`resample_np` on each
decode's host PCM, so the audio stays host numpy on both sides, as with
the JAX package's ``resample_np``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _signal


@lru_cache(maxsize=32)
def _design(src_rate: int, dst_rate: int):
    """Return (up, down, fir) for a rate pair. fir is float32, scaled by up."""
    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    if up == down:
        return 1, 1, None
    max_rate = max(up, down)
    half_len = 10 * max_rate  # 10 taps per zero crossing, resample_poly default
    fir = _signal.firwin(
        2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)
    ).astype(np.float32)
    return up, down, fir * up


def resample(audio: torch.Tensor, src_rate: int, dst_rate: int) -> torch.Tensor:
    """Resample a (T,) or (B, T) float32 waveform between fixed rates, on
    the tensor's device. Output length is ``ceil(T * dst / src)``."""
    up, down, fir = _design(src_rate, dst_rate)
    if fir is None:
        return audio
    squeeze = audio.dim() == 1
    x = audio[None, :] if squeeze else audio
    b, t = x.shape
    n_out = -(-t * up // down)  # ceil
    h = torch.from_numpy(fir).to(x.device)
    half = h.shape[0] // 2
    # zero-stuff: input sample i lands at position i * up
    stuffed = x.new_zeros((b, (t - 1) * up + 1))
    stuffed[:, ::up] = x
    y = F.conv1d(F.pad(stuffed, (half, half + down))[:, None, :], h[None, None, :],
                 stride=down)[:, 0, :n_out]
    return y[0] if squeeze else y


def resample_np(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Host helper: a numpy waveform through :func:`resample` on the CPU."""
    with torch.inference_mode():
        out = resample(torch.from_numpy(np.ascontiguousarray(audio, np.float32)),
                       src_rate, dst_rate)
    return out.numpy()


__all__ = ["resample", "resample_np"]
