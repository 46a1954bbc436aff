"""Encoder flash self-attention kernel: wrapper, launch count and plain version.

Replaces the Pallas TPU flash-attention kernel that
``stt_tpu/models/whisper.py::_flash_self_attention`` reaches
(``jax.experimental.pallas.ops.tpu.flash_attention``, non-causal,
``sm_scale`` 1) with the CUDA kernel in
``stt_tpu_torch/ops/cuda/flash_attention.cu``. It computes softmax(Q Kᵀ)·V
over the T real keys, with q and k pre-scaled by d_head**-0.25: float32
scores and online softmax, the unnormalised weights rounded to the input
type before the P·V product, one division by the running sum at the end.
The TPU path pads T to 128 and masks the padding with segment ids; the
kernel masks the ragged last key tile itself, so nothing is padded.

The function does 4·T²·Dh flops per (row, head) against ~8·T·Dh bytes, so
at the encoder's T = 1500 it is bound by arithmetic. The bf16 body (the
serving path's type) runs it on the tensor cores through ``wgmma``, fed by
TMA copies into a ring of shared memory that one producer warp keeps full
for three consumer warpgroups. The float32 body, for engines built with
``compute_type="float32"``, runs it in float32 FMAs on the CUDA cores, one
thread per query row over K/V tiles in shared memory, with nothing rounded
below float32 (no TF32).

:func:`flash_attention` dispatches on the tensors' device and type: CUDA
tensors go to the kernel body of their type, CPU tensors (bf16 or float32)
to :func:`flash_attention_plain`. On the card it launches a kernel or
raises; it never takes the plain version. ``flash_attention.launches``
counts kernel launches of either body.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..cuda import build

HEAD_DIMS = (16, 32, 64)


def flash_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unmasked ``_attn_cached`` over (B, H, T, Dh)
    q/k/v -> (B, H, T, Dh) in q's type (float32 logits and softmax,
    weights rounded to q's type before the float32 mix)."""
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(qh.dtype)
    return torch.matmul(weights.float(), vh.to(qh.dtype).float()).to(qh.dtype)


_ENTRY_POINTS = {torch.bfloat16: "flash_attention_launch",
                 torch.float32: "flash_attention_f32_launch"}


@lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    """Build and load ``flash_attention.cu`` (first call only) and type the
    launcher of the body for ``dtype``."""
    fn = getattr(build.load("flash_attention"), _ENTRY_POINTS[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Non-causal self-attention over (B, H, T, Dh) q/k/v (q and k
    pre-scaled) -> (B, H, T, Dh) in q's type. CPU tensors take the plain
    version; CUDA tensors the kernel body of their type (bf16 or float32)."""
    if qh.ndim != 4 or kh.shape != qh.shape or vh.shape != qh.shape:
        raise ValueError(f"flash_attention wants q/k/v of one (B, H, T, Dh) shape, got "
                         f"{tuple(qh.shape)}, {tuple(kh.shape)}, {tuple(vh.shape)}")
    if qh.dtype not in (torch.bfloat16, torch.float32) or kh.dtype != qh.dtype \
            or vh.dtype != qh.dtype:
        raise TypeError(f"q/k/v must share bfloat16 or float32, got "
                        f"{qh.dtype}, {kh.dtype}, {vh.dtype}")
    if qh.device.type == "cpu" and kh.device.type == "cpu" and vh.device.type == "cpu":
        return flash_attention_plain(qh, kh, vh)
    if not (qh.device.type == kh.device.type == vh.device.type == "cuda") \
            or not (qh.device == kh.device == vh.device):
        raise ValueError(f"flash_attention runs on one CUDA device or the CPU, got "
                         f"{qh.device}, {kh.device}, {vh.device}")
    if not (qh.is_contiguous() and kh.is_contiguous() and vh.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k and v")
    b, h, t, dh = qh.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} unsupported (one of {HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} above the grid's 65535")
    if any(x.data_ptr() % 16 for x in (qh, kh, vh)):
        raise ValueError("flash_attention wants 16-byte aligned q, k and v (TMA, "
                         "float4 loads)")
    out = torch.empty_like(qh)
    if b * h * t == 0:
        return out
    launch = _launcher(qh.dtype)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = launch(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
                    b * h, t, dh, stream)
    if rc != 0:
        what = (f"cuTensorMapEncodeTiled CUresult {rc - 1000}" if rc > 1000
                else f"cudaError {rc}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_plain"]
