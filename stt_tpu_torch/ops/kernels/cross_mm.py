"""Cross-attention products over int8 K/V codes: wrappers, launch counts,
plans and plain versions.

The einsum route of cross-attention (``xattn_kernel`` off) at one decode
position over int8 storage. ``_attn_cached`` widens the layer's stored K/V
to a bf16 copy before each product; these two launches of
``stt_tpu_torch/ops/cuda/cross_mm.cu`` read the codes instead, converting
them on load as the JAX package's XLA einsum does, so an element of K/V
costs one byte of device memory instead of five. They keep the einsum's
structure and rounding:

- :func:`cross_logits`: q (B, H, Dh) bf16 against the K codes (B, H, Ta,
  Dh) int8 -> float32 logits (B, H, Ta);
- :func:`cross_mix`: the float32 softmax of those logits (B, H, Ta),
  rounded to bf16 on load, against the V codes -> float32 (B, H, Dh).

The softmax between them stays torch's, in float32; the per-(row, head)
scales stay folded into q and the output by the caller
(``stt_tpu_torch.models.whisper._cross_layer_attn``). Both launches are
bound by device-memory bytes; :func:`plan_logits` cuts each (row, head)'s
keys into tiles and :func:`plan_mix` into a thread-block cluster, so that
a small batch still fills the card (the source's note has the design).

Each wrapper dispatches on the tensors' device: CUDA tensors go to the
kernel, CPU tensors to the plain version (``_attn_cached``'s products on
the CPU), meta tensors to an empty result of the kernel's shape and type
(the card's route traced without a card). On the card it launches the kernel or raises; it never takes the
plain version. ``cross_logits.launches`` and ``cross_mix.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from ..cuda import build
from .xattn_decode import H100_SMS, _sm_count

THREADS = 256
VEC = 16          # int8 codes in one 16-byte load
AHEAD = 4         # 16-byte loads each thread has in flight (kAhead in the source)
CLUSTER_MAX = 8   # the portable cluster size


def cross_logits_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cross_logits`: ``_attn_cached``'s
    first product on the CPU (operands widened to float32, which holds a
    bf16 value and an int8 code exactly)."""
    return torch.matmul(q.float()[:, :, None, :], k.float().transpose(-1, -2))[:, :, 0, :]


def cross_mix_plain(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cross_mix`: ``_attn_cached``'s second
    product on the CPU, the weights rounded to bf16 first."""
    return torch.matmul(w.to(torch.bfloat16).float()[:, :, None, :], v.float())[:, :, 0, :]


def rows_per_pass(dh: int) -> int:
    """K/V rows one block's 256 threads load with one 16-byte load each."""
    return THREADS * VEC // dh


def plan_logits(bh: int, ta: int, dh: int, sms: int = H100_SMS) -> int:
    """Keys per block of :func:`cross_logits` for B*H = ``bh`` (row, head)
    pairs over ``ta`` keys. A block takes at most the AHEAD passes of rows
    its threads load at once, so the grid is many short blocks and its last
    wave is a small share of it (one block a pair left 64 x 12 x 1500 at 1.45
    waves); the chunk is halved while the grid holds fewer than two blocks an
    SM and a block keeps at least one full pass. The grid has ceil(ta /
    chunk) tiles a pair, the last one possibly shorter."""
    if bh < 1 or ta < 1:
        raise ValueError(f"plan_logits needs bh >= 1 and ta >= 1, got {bh}, {ta}")
    chunk = AHEAD * rows_per_pass(dh)
    while bh * -(-ta // chunk) < 2 * sms and chunk // 2 >= rows_per_pass(dh):
        chunk //= 2
    return chunk


def plan_mix(bh: int, ta: int, dh: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(cluster size C, keys per block) of :func:`cross_mix`: C, a power of
    two, doubles while the grid holds fewer blocks than the card has SMs, C
    stays portable (<= 8) and each block keeps at least one full pass of
    rows. The cluster's exchange costs more than it gains beyond one block
    an SM (on the H100, at 16 x 12 x 1500: 18.2 us at C = 1, 17.8 at 2,
    23.9 at 8; at 64 x 12 x 1500: 45.0 at 1, 68.5 at 8; at 4 x 12 x 1500 C
    = 8 takes 11.5 us against 13.4 at 1). chunk = ceil(ta / C), so the
    last block may get fewer keys than the others, or none."""
    if bh < 1 or ta < 1:
        raise ValueError(f"plan_mix needs bh >= 1 and ta >= 1, got {bh}, {ta}")
    clusters = 1
    while (2 * clusters <= CLUSTER_MAX and bh * clusters < sms
           and -(-ta // (2 * clusters)) >= rows_per_pass(dh)):
        clusters *= 2
    return clusters, -(-ta // clusters)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build and load ``cross_mm.cu`` (first call only) and type its launchers."""
    lib = build.load("cross_mm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cross_logits_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.cross_mix_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.cross_logits_launch.restype = lib.cross_mix_launch.restype = ctypes.c_int
    return lib


def _check(name: str, a: torch.Tensor, want: Tuple[int, ...], a_dtype: torch.dtype,
           codes: torch.Tensor) -> str:
    """Checks operand ``a`` (shape ``want``, type ``a_dtype``) beside the
    (B, H, Ta, Dh) int8 ``codes``; returns the device type both lie on:
    "cpu" (the plain version), "meta" (shapes only) or "cuda"."""
    if tuple(a.shape) != tuple(want):
        raise ValueError(f"{name} wants {tuple(want)} beside codes {tuple(codes.shape)}, "
                         f"got {tuple(a.shape)}")
    if a.dtype != a_dtype or codes.dtype != torch.int8:
        raise TypeError(f"{name} wants {a_dtype} and int8 codes, got {a.dtype}, {codes.dtype}")
    if a.device.type == codes.device.type and a.device.type in ("cpu", "meta"):
        return a.device.type
    if not (a.device.type == "cuda" and a.device == codes.device):
        raise ValueError(f"{name} runs on one CUDA device or the CPU, got {a.device}, "
                         f"{codes.device}")
    if not (a.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"{name} wants contiguous operands")
    b, h, ta, dh = codes.shape
    ndg = dh // VEC
    if dh % VEC or ndg < 1 or ndg > 32 or ndg & (ndg - 1):
        raise ValueError(f"head dim {dh} unsupported: Dh must fill a power-of-two count "
                         f"(<= 32) of 16-byte loads")
    if ta < 1 or b * h > 65535:
        raise ValueError(f"{name} takes 1 or more keys and B*H <= 65535, got Ta={ta}, "
                         f"B*H={b * h}")
    if any(t.data_ptr() % 16 for t in (a, codes)):
        raise ValueError(f"{name} wants 16-byte aligned operands")
    return "cuda"


def _codes_shape(name: str, codes: torch.Tensor) -> Tuple[int, int, int, int]:
    if codes.ndim != 4:
        raise ValueError(f"{name} wants (B, H, Ta, Dh) codes, got {tuple(codes.shape)}")
    return tuple(codes.shape)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def cross_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, H, Dh) bf16 against the K codes (B, H, Ta, Dh) int8 -> float32
    logits (B, H, Ta). CPU tensors take the plain version; CUDA tensors the
    kernel; meta tensors give the result's shape and type."""
    b, h, ta, dh = _codes_shape("cross_logits", k)
    device = _check("cross_logits", q, (b, h, dh), torch.bfloat16, k)
    if device == "cpu":
        return cross_logits_plain(q, k)
    out = torch.empty((b, h, ta), dtype=torch.float32, device=q.device)
    if device == "meta" or b * h == 0:
        return out
    chunk = plan_logits(b * h, ta, dh, _sm_count(q.device))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cross_logits_launch(q.data_ptr(), k.data_ptr(), out.data_ptr(), b * h, ta, dh,
                                     chunk, stream)
    _raise_on("cross_logits", rc)
    cross_logits.launches += 1
    return out


def cross_mix(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Float32 weights w (B, H, Ta), rounded to bf16 on load, against the V
    codes (B, H, Ta, Dh) int8 -> float32 (B, H, Dh). CPU tensors take the
    plain version; CUDA tensors the kernel; meta tensors give the result's
    shape and type."""
    b, h, ta, dh = _codes_shape("cross_mix", v)
    device = _check("cross_mix", w, (b, h, ta), torch.float32, v)
    if device == "cpu":
        return cross_mix_plain(w, v)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=w.device)
    if device == "meta" or b * h == 0:
        return out
    clusters, chunk = plan_mix(b * h, ta, dh, _sm_count(w.device))
    lib = _library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.cross_mix_launch(w.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, ta, dh,
                                  clusters, chunk, stream)
    _raise_on("cross_mix", rc)
    cross_mix.launches += 1
    return out


cross_logits.launches = 0
cross_mix.launches = 0

__all__ = ["cross_logits", "cross_logits_plain", "cross_mix", "cross_mix_plain",
           "plan_logits", "plan_mix", "rows_per_pass"]
