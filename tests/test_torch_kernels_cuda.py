"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on hosts without a CUDA
device. This file imports no JAX, so it also runs on the GPU host:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

The log-mel kernel is held at the tolerance of ``tests/test_pallas_mel.py``
(atol 2e-4, rtol 1e-4) after the shared epilogue: kernel and plain
version are both float32 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.engine.engine import _encode_wire_rows
from stt_tpu_torch.ops.kernels.mel import log_mel_spectrogram_plain, mel_logspec
from stt_tpu_torch.ops.mel import normalize_log_mel

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(wire, batch, seconds, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t) + 0.05 * rng.normal(0, 1, t.shape)
        for i in range(batch)
    ]).astype(np.float32)
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    return torch.from_numpy({"mulaw": _encode_wire_rows(pcm), "int16": pcm,
                             "float32": audio}[wire])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["mulaw", "int16", "float32"])
@pytest.mark.parametrize("batch,seconds", [(1, 1.0), (3, 5.0), (2, 1.5), (4, 30.0)])
def test_mel_kernel_matches_plain(cuda_device, wire, batch, seconds):
    rows = _rows(wire, batch, seconds).to(cuda_device)
    before = mel_logspec.launches
    got = normalize_log_mel(mel_logspec(rows))
    torch.cuda.synchronize()
    assert mel_logspec.launches == before + 1
    assert got.shape == (batch, 80, int(seconds * 100))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_mel_kernel_silence(cuda_device):
    rows = torch.zeros((2, 16000), dtype=torch.int16, device=cuda_device)
    got = normalize_log_mel(mel_logspec(rows))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_mel_kernel_rejects_bad_input(cuda_device):
    with pytest.raises(ValueError):
        mel_logspec(torch.zeros((1, 16007), device=cuda_device))
    with pytest.raises(TypeError):
        mel_logspec(torch.zeros((1, 16000), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        mel_logspec(torch.zeros((16000, 2), device=cuda_device).t())
