"""Cross-attention decode kernel: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``stt_tpu/ops/pallas/xattn_decode.py``
(``xattn_decode``; bodies ``_xattn_kernel``, ``_xattn_kernel_vpu``,
``_xattn_kernel_mm``, ``_xattn_kernel_mmd``) with the CUDA kernel in
``stt_tpu_torch/ops/cuda/xattn_decode.cu``. For one decode position and
each (row, head) it computes softmax(q·Kᵀ)·V over the precomputed cross
K/V: float32 scores and softmax, weights rounded to bf16 after they are
normalised, a float32 mix. q and the stored K/V are rounded to bf16 on
load, as the TPU ``mm`` body does, so float32 storage (float32 compute)
takes the kernel too.

K/V are stored as bf16, fp8 e4m3, int8 or float32. int8 storage carries
per-(row, head) scales that the caller folds into q and the output (see
``stt_tpu_torch.models.whisper._cross_layer_attn``); the kernel only
converts the codes on load. The function reads K and V once and does ~4
flops a pair of elements, so it is bound by device-memory bytes; the
source's note says how the design reads each byte once.

:func:`xattn_decode` dispatches on the tensors' device: CUDA tensors go
to the kernel, CPU tensors to :func:`xattn_decode_plain`. On the card it
launches the kernel or raises; it never takes the plain version.
``xattn_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..cuda import build

THREADS = 256
SMEM_LIMIT = 48 * 1024  # bytes of dynamic shared memory the launch may ask for
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.int8: 3}


def xattn_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q (B, H, Dh), k/v (B, H, Ta, Dh)
    in their storage type -> (B, H, Dh) float32, with ``_attn_cached``'s
    rounding at Tq = 1 on bf16-rounded inputs."""
    qb = q.to(torch.bfloat16).float()[:, :, None, :]
    kb = k.to(torch.bfloat16).float()
    vb = v.to(torch.bfloat16).float()
    logits = torch.matmul(qb, kb.transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(torch.bfloat16)
    return torch.matmul(weights.float(), vb)[:, :, 0, :]


def max_ta(dh: int, kv_dtype: torch.dtype) -> int:
    """Longest cross context one launch takes: scores, q and the mix
    partials share 48 KB of dynamic shared memory."""
    vec = 16 // torch.empty((), dtype=kv_dtype).element_size()
    return SMEM_LIMIT // 4 - dh - THREADS * vec


@lru_cache(maxsize=None)
def _launcher():
    """Build and load ``xattn_decode.cu`` (first call only) and type its launcher."""
    fn = build.load("xattn_decode").xattn_decode_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[2]:
        raise ValueError(f"xattn_decode wants q (B, H, Dh) and k/v (B, H, Ta, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"k/v must share one of {sorted(map(str, _KV_CODES))}, "
                        f"got {k.dtype} and {v.dtype}")


def xattn_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-position cross-attention: q (B, H, Dh) pre-scaled by
    d_head**-0.25, k/v (B, H, Ta, Dh) stored (k pre-scaled) -> (B, H, Dh)
    float32. CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return xattn_decode_plain(q, k, v)
    if not (q.device.type == k.device.type == v.device.type == "cuda") \
            or not (q.device == k.device == v.device):
        raise ValueError(f"xattn_decode runs on one CUDA device or the CPU, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("xattn_decode wants contiguous q, k and v")
    b, h, ta, dh = k.shape
    ndg = dh * k.element_size() // 16
    if dh * k.element_size() % 16 or ndg < 1 or ndg > 32 or ndg & (ndg - 1):
        raise ValueError(f"head dim {dh} unsupported for {k.dtype}: Dh must fill "
                         f"a power-of-two count (<= 32) of 16-byte loads")
    if ta < 1 or ta > max_ta(dh, k.dtype):
        raise ValueError(f"cross context Ta={ta} outside [1, {max_ta(dh, k.dtype)}] "
                         f"(shared-memory limit of one launch)")
    if any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("k and v must be 16-byte aligned")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    if b * h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), _Q_CODES[q.dtype], k.data_ptr(), v.data_ptr(),
                    _KV_CODES[k.dtype], out.data_ptr(), b * h, ta, dh, stream)
    if rc != 0:
        raise RuntimeError(f"xattn_decode kernel launch failed: cudaError {rc}")
    xattn_decode.launches += 1
    return out


xattn_decode.launches = 0

__all__ = ["max_ta", "xattn_decode", "xattn_decode_plain"]
