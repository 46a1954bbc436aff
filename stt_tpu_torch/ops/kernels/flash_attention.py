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
``compute_type="float32"``, runs it in float32 FMAs on the CUDA cores, with
nothing rounded below float32 (no TF32): blocks of 128 query rows in 128
threads, each thread an 8 x 8 micro-tile of scores and 8 rows of the
output, 64-key K/V tiles copied ahead into shared memory.
:func:`plan_f32` splits the keys over a cluster of blocks when the grid
would load the SMs unevenly.

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
from .xattn_decode import H100_SMS, _sm_count

HEAD_DIMS = (16, 32, 64)
F32_ROWS = 128          # query rows per block of the float32 body
F32_KEYS = 64           # keys per K/V tile
F32_BLOCKS_PER_SM = 2   # resident blocks: up to 255 registers x 128 threads, 101 KB shared memory
F32_MAX_SPLIT = 8       # blocks of one cluster, the portable size


def flash_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unmasked ``_attn_cached`` over (B, H, T, Dh)
    q/k/v -> (B, H, T, Dh) in q's type (float32 logits and softmax,
    weights rounded to q's type before the float32 mix)."""
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(qh.dtype)
    return torch.matmul(weights.float(), vh.to(qh.dtype).float()).to(qh.dtype)


def plan_f32(bh: int, t: int, sms: int = H100_SMS) -> int:
    """Key splits for the float32 body: how many blocks of one cluster share
    each query block's keys, for B*H = ``bh`` heads of ``t`` positions.

    A grid of ceil(t / 128) * bh * splits blocks spreads n = ceil(blocks /
    sms) blocks onto its most loaded SM, which holds F32_BLOCKS_PER_SM at
    once. Two resident blocks share the SM's FMA pipes; a block left alone
    (the odd one of n) runs at ~2/3 of the SM's rate, since its 4 warps
    cannot keep the pipes full, so that SM takes n + (n % 2) / 2 block
    times. A block's time is its ceil(n_tiles / splits) key tiles plus about
    two tiles of fixed work (the Q tile, the first copies, the combine).
    The cheapest split count wins, the smaller on a tie; a count that would
    leave a block without a tile is skipped (it is a smaller count's grid).
    At 12 heads x 1500: 3 splits for 1 row, 2 for 4, none for 16 and 64.
    """
    if bh < 1 or t < 1:
        raise ValueError(f"plan_f32 needs bh >= 1 and t >= 1, got {bh}, {t}")
    n_tiles = -(-t // F32_KEYS)
    blocks = -(-t // F32_ROWS) * bh
    best, best_cost = 1, None
    for splits in range(1, min(F32_MAX_SPLIT, n_tiles) + 1):
        per = -(-n_tiles // splits)
        if -(-n_tiles // per) != splits:
            continue
        n = -(-blocks * splits // sms)
        cost = (n + (n % 2) / 2) * (per + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


def f32_waves(bh: int, t: int, splits: int, sms: int = H100_SMS) -> float:
    """Blocks of the float32 body's grid over the blocks the card holds at once."""
    return -(-t // F32_ROWS) * bh * splits / (F32_BLOCKS_PER_SM * sms)


_ENTRY_POINTS = {torch.bfloat16: "flash_attention_launch",
                 torch.float32: "flash_attention_f32_launch"}


@lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    """Build and load ``flash_attention.cu`` (first call only) and type the
    launcher of the body for ``dtype`` (the float32 one also takes the
    split)."""
    fn = getattr(build.load("flash_attention"), _ENTRY_POINTS[dtype])
    ints = 4 if dtype == torch.float32 else 3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [ctypes.c_void_p]
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
    extra = (plan_f32(b * h, t, _sm_count(qh.device)),) if qh.dtype == torch.float32 else ()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = launch(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
                    b * h, t, dh, *extra, stream)
    if rc != 0:
        what = (f"cuTensorMapEncodeTiled CUresult {rc - 1000}" if rc > 1000
                else f"cudaError {rc}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["HEAD_DIMS", "f32_waves", "flash_attention", "flash_attention_plain", "plan_f32"]
