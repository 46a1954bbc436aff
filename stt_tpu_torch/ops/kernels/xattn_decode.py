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
flops a pair of elements, so it is bound by device-memory bytes. The kernel
splits each (row, head)'s Ta keys across a thread-block cluster so that a
small batch still puts enough bytes in flight; :func:`plan_split` picks the
cluster size and the chunk of keys each block takes, and the source's note
says how the blocks meet through distributed shared memory.

:func:`xattn_decode` dispatches on the tensors' device: CUDA tensors go
to the kernel, CPU tensors to :func:`xattn_decode_plain`. On the card it
launches the kernel or raises; it never takes the plain version.
``xattn_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from ..cuda import build

THREADS = 256
CHUNK_MAX = 8192        # keys one block takes: its scores fill 32 KB of shared memory
CLUSTER_PORTABLE = 8    # cluster size every Hopper launch accepts
CLUSTER_MAX = 16        # with cudaFuncAttributeNonPortableClusterSizeAllowed
H100_SMS = 132
# longest cross context one launch takes, for every head dim and storage type
MAX_TA = CLUSTER_MAX * CHUNK_MAX
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


def rows_per_pass(dh: int, itemsize: int) -> int:
    """K/V rows one block's 256 threads load with one 16-byte load each."""
    return THREADS * 16 // (dh * itemsize)


def plan_split(bh: int, ta: int, dh: int, itemsize: int,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(cluster size C, keys per block) for B*H = ``bh`` (row, head) pairs
    over ``ta`` keys of ``itemsize``-byte K/V.

    C is a power of two. It starts at the fewest blocks whose chunks fit
    CHUNK_MAX, then doubles while the grid holds fewer than two blocks per
    SM, C stays portable (<= 8) and each block still gets at least one
    full pass of rows. A large B*H needs no split (64 x 12 pairs already
    fill the card). chunk = ceil(ta / C), so the last block may get fewer
    keys than the others, or none.
    """
    if bh < 1 or ta < 1:
        raise ValueError(f"plan_split needs bh >= 1 and ta >= 1, got {bh}, {ta}")
    if ta > MAX_TA:
        raise ValueError(f"Ta={ta} above {MAX_TA}")
    clusters = 1 << (-(-ta // CHUNK_MAX) - 1).bit_length()
    min_rows = rows_per_pass(dh, itemsize)
    while (2 * clusters <= CLUSTER_PORTABLE and bh * clusters < 2 * sms
           and -(-ta // (2 * clusters)) >= min_rows):
        clusters *= 2
    return clusters, -(-ta // clusters)


@lru_cache(maxsize=None)
def _launcher():
    """Build and load ``xattn_decode.cu`` (first call only) and type its launcher."""
    fn = build.load("xattn_decode").xattn_decode_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if ta < 1 or ta > MAX_TA:
        raise ValueError(f"cross context Ta={ta} outside [1, {MAX_TA}] "
                         f"(shared-memory limit of one cluster launch)")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} above the grid's 65535")
    if any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("k and v must be 16-byte aligned")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    if b * h == 0:
        return out
    launch = _launcher()
    clusters, chunk = plan_split(b * h, ta, dh, k.element_size(), _sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), _Q_CODES[q.dtype], k.data_ptr(), v.data_ptr(),
                    _KV_CODES[k.dtype], out.data_ptr(), b * h, ta, dh, clusters, chunk,
                    stream)
    if rc != 0:
        raise RuntimeError(f"xattn_decode kernel launch failed: cudaError {rc}")
    xattn_decode.launches += 1
    return out


xattn_decode.launches = 0

__all__ = ["MAX_TA", "plan_split", "rows_per_pass", "xattn_decode", "xattn_decode_plain"]
