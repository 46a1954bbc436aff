"""Fused log-mel kernel: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``stt_tpu/ops/pallas/mel.py``
(``log_mel_spectrogram_pallas``, body ``_mel_kernel``) with the CUDA
kernel in ``stt_tpu_torch/ops/cuda/mel.cu``. Both compute the un-clamped
``log10`` mel power (B, n_mels, T // hop); the per-row ``max - 8`` clamp
and ``(x + 4) / 4`` epilogue (:func:`stt_tpu_torch.ops.mel.normalize_log_mel`)
follow in plain PyTorch. Unlike the Pallas kernel, this one also takes
the engine's compressed wire (uint8 mu-law or int16 PCM) and expands it
while loading, so the float32 waveform never exists in device memory.

The kernel computes the 400-point real DFT as a 200-point complex FFT
(radix 8, 5, 5, in shared memory, one warp per frame) and the mel
projection over each Slaney filter's run of non-zero bins: ~10.5 kflop per
frame, the function's own work, against ~170 bytes moved, so operations
and bytes bound it about equally. The tables it needs (the Hann window,
the twiddles, the sparse filterbank) are computed here in float64, rounded
once to float32 and handed to it; see the note in the CUDA source.

:func:`mel_logspec` dispatches on the tensor's device: a CUDA tensor goes
to the kernel, a CPU tensor to :func:`log_mel_spectrogram_plain`. On the
card it launches the kernel or raises; it never takes the plain version.
``mel_logspec.launches`` counts kernel launches, so a run can show that
its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from .. import mel as M
from ..cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.int16: 1, torch.uint8: 2}
_constants: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, ...]] = {}

# the FFT's twiddle table, in the layout mel.cu reads: (cos, -sin) pairs
TW_STAGE2 = 0     # W40^(j k1), j 1..4, k1 0..7, at (j-1)*8 + k1
TW_STAGE3 = 32    # W200^(j k1), j 1..4, k1 0..39, at (j-1)*40 + k1
TW_SPLIT = 192    # W400^k, k 0..100
TW_RADIX = 293    # W5^1, W5^2, W8^1
TW_COUNT = 296
MAX_MELS = 128    # filters the kernel stages in shared memory


def log_mel_spectrogram_plain(rows: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain PyTorch version of the kernel: wire rows (B, T) in uint8
    mu-law, int16 or float32 -> ``log10`` mel power (B, n_mels, T // hop)."""
    if rows.ndim == 1:
        rows = rows[None]
    return M.log_mel_raw(M.expand_wire(rows), n_mels)


def hann_window() -> np.ndarray:
    """The periodic Hann window of ``_dft_basis``, rounded once to float32
    (400,)."""
    return np.hanning(M.N_FFT + 1)[:-1].astype(np.float32)


def _unit(turns) -> np.ndarray:
    """exp(-2 pi i turns) in float64 as (cos, -sin) pairs."""
    angle = 2.0 * np.pi * np.asarray(turns, np.float64)
    return np.stack([np.cos(angle), -np.sin(angle)], axis=-1)


def twiddles() -> np.ndarray:
    """The FFT's twiddle table (``TW_COUNT``, 2) in float64; the kernel
    gets it rounded once to float32."""
    j = np.arange(1, 5)[:, None]
    table = np.concatenate([
        _unit(j * np.arange(8) / 40).reshape(-1, 2),
        _unit(j * np.arange(40) / 200).reshape(-1, 2),
        _unit(np.arange(101) / 400),
        _unit([1 / 5, 2 / 5, 1 / 8]),
    ])
    assert table.shape == (TW_COUNT, 2)
    return table


def sparse_filterbank(n_mels: int) -> Tuple[np.ndarray, np.ndarray]:
    """``mel_filterbank(n_mels)`` as each filter's run of non-zero bins:
    (n_mels, 3) int32 (first bin, length, offset into the weights) and the
    packed float32 weights. Raises if a filter's non-zeros are not one run."""
    fb = M.mel_filterbank(n_mels, M.N_FFT)
    filters = np.zeros((n_mels, 3), np.int32)
    runs = []
    offset = 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        first, length = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        if length != nz.size:
            raise ValueError(f"mel filter {m} is not one run of bins")
        filters[m] = first, length, offset
        runs.append(row[first:first + length])
        offset += length
    return filters, np.concatenate(runs).astype(np.float32)


def _device_constants(device: torch.device, n_mels: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's tables on ``device``: window, twiddles, filters, weights."""
    key = (device, n_mels)
    if key not in _constants:
        tables = (hann_window(), twiddles().astype(np.float32), *sparse_filterbank(n_mels))
        _constants[key] = tuple(torch.from_numpy(x).to(device).contiguous() for x in tables)
    return _constants[key]


@lru_cache(maxsize=None)
def _launcher():
    """Build and load ``mel.cu`` (first call only) and type its launcher."""
    fn = build.load("mel").mel_logspec_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def mel_logspec(rows: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Wire rows (B, T) -> ``log10`` mel power (B, n_mels, T // hop), float32.

    T must be a multiple of the hop (160) — the engine's buckets always
    are. CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if rows.ndim == 1:
        rows = rows[None]
    if rows.ndim != 2:
        raise ValueError(f"audio rows must be (B, T), got shape {tuple(rows.shape)}")
    M.check_audio_length(rows.shape[1])
    if rows.device.type == "cpu":
        return log_mel_spectrogram_plain(rows, n_mels)
    if rows.device.type != "cuda":
        raise ValueError(f"mel_logspec runs on CUDA or CPU, not {rows.device}")
    if rows.dtype not in _DTYPE_CODES:
        raise TypeError(f"audio rows must be uint8, int16 or float32, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("audio rows must be contiguous")
    if n_mels > MAX_MELS:
        raise ValueError(f"the log-mel kernel takes at most {MAX_MELS} mels, got {n_mels}")
    b, t = rows.shape
    out = torch.empty((b, n_mels, t // M.HOP_LENGTH), dtype=torch.float32,
                      device=rows.device)
    if b == 0:
        return out
    launch = _launcher()
    window, twiddle, filters, weights = _device_constants(rows.device, n_mels)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = launch(rows.data_ptr(), _DTYPE_CODES[rows.dtype], window.data_ptr(),
                    twiddle.data_ptr(), filters.data_ptr(), weights.data_ptr(),
                    out.data_ptr(), b, t, n_mels, weights.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"mel_logspec kernel launch failed: cudaError {rc}")
    mel_logspec.launches += 1
    return out


mel_logspec.launches = 0

__all__ = ["hann_window", "log_mel_spectrogram_plain", "mel_logspec", "sparse_filterbank",
           "twiddles"]
