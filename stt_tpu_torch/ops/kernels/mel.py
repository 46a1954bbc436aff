"""Fused log-mel kernel: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``stt_tpu/ops/pallas/mel.py``
(``log_mel_spectrogram_pallas``, body ``_mel_kernel``) with the CUDA
kernel in ``stt_tpu_torch/ops/cuda/mel.cu``. Both compute the un-clamped
``log10`` mel power (B, n_mels, T // hop); the per-row ``max - 8`` clamp
and ``(x + 4) / 4`` epilogue (:func:`stt_tpu_torch.ops.mel.normalize_log_mel`)
follow in plain PyTorch. Unlike the Pallas kernel, this one also takes
the engine's compressed wire (uint8 mu-law or int16 PCM) and expands it
while loading, so the float32 waveform never exists in device memory.

The kernel computes the DFT as a dense product (about 354 kflop per frame
at 80 mels) and so is bound by float32 arithmetic on the CUDA cores; the
function itself needs ~10 kflop per frame through an FFT against ~170
bytes moved, which puts its floor at the memory roofline. See the note in
the CUDA source for how the design keeps every intermediate on chip.

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

import torch

from .. import mel as M
from ..cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.int16: 1, torch.uint8: 2}
_constants: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def log_mel_spectrogram_plain(rows: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain PyTorch version of the kernel: wire rows (B, T) in uint8
    mu-law, int16 or float32 -> ``log10`` mel power (B, n_mels, T // hop)."""
    if rows.ndim == 1:
        rows = rows[None]
    return M.log_mel_raw(M.expand_wire(rows), n_mels)


def _device_constants(device: torch.device, n_mels: int):
    key = (device, n_mels)
    if key not in _constants:
        basis = torch.from_numpy(M._dft_basis(M.N_FFT)).to(device)
        mel_t = torch.from_numpy(M.mel_filterbank(n_mels, M.N_FFT).T.copy()).to(device)
        _constants[key] = (basis.contiguous(), mel_t.contiguous())
    return _constants[key]


@lru_cache(maxsize=None)
def _launcher():
    """Build and load ``mel.cu`` (first call only) and type its launcher."""
    fn = build.load("mel").mel_logspec_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
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
    b, t = rows.shape
    out = torch.empty((b, n_mels, t // M.HOP_LENGTH), dtype=torch.float32,
                      device=rows.device)
    if b == 0:
        return out
    launch = _launcher()
    basis, mel_t = _device_constants(rows.device, n_mels)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = launch(rows.data_ptr(), _DTYPE_CODES[rows.dtype], basis.data_ptr(),
                    mel_t.data_ptr(), out.data_ptr(), b, t, n_mels, stream)
    if rc != 0:
        raise RuntimeError(f"mel_logspec kernel launch failed: cudaError {rc}")
    mel_logspec.launches += 1
    return out


mel_logspec.launches = 0

__all__ = ["log_mel_spectrogram_plain", "mel_logspec"]
