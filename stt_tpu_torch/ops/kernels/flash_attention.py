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

Under grad (a training step) the call goes through an autograd Function,
the counterpart of the library's ``jax.custom_vjp``: its forward asks the
kernel for each row's log-sum-exp as well (both bodies write it when given
a buffer; the served call gives none), and its backward is
:func:`flash_attention_backward`: di = Σ(o·dO) in plain torch, as the
library computes it outside its kernels, then the two backward kernels of
``stt_tpu_torch/ops/cuda/flash_attention_bwd.cu``,
:func:`flash_attention_bwd_dkv` (dK, dV) and :func:`flash_attention_bwd_dq`
(dQ), which replace the library's ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``. Each counts its launches; CPU tensors take
their plain versions (:func:`flash_attention_backward_plain`). Each
backward kernel has a bf16 body on the tensor cores (``wgmma`` fed by TMA,
P and dS in registers, rounded to bf16 before their products as the TPU
bodies round them) and a float32 body on the CUDA cores (8 x 8 register
micro-tiles, tiles copied ahead by ``cp.async``); the plain versions round
P and dS to q's type the same way.
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


def flash_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                          with_lse: bool = False):
    """Plain PyTorch version: unmasked ``_attn_cached`` over (B, H, T, Dh)
    q/k/v -> (B, H, T, Dh) in q's type (float32 logits and softmax,
    weights rounded to q's type before the float32 mix). ``with_lse`` also
    returns each row's float32 log-sum-exp of its scores, (B, H, T)."""
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(qh.dtype)
    out = torch.matmul(weights.float(), vh.to(qh.dtype).float()).to(qh.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _grads_of_scores(qh, kh, vh, dout, lse, di):
    """P = exp(S - lse) and dS = P (dP - di) in float32, (B, H, T, T)."""
    q, k, v, g = (x.float() for x in (qh, kh, vh, dout))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) - lse[..., None])
    ds = p * (torch.matmul(g, v.transpose(-1, -2)) - di[..., None])
    return q, k, g, p, ds


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and widened back to float32 (a no-op in float32)."""
    return x.to(dtype).float()


def flash_attention_bwd_dkv_plain(qh, kh, vh, dout, lse, di):
    """Plain version of the dK/dV kernel: (dK, dV) in q's type. P and dS are
    float32, then rounded to q's type before the products, as the library's
    Pallas body rounds them (``p.T.astype(do.dtype)``,
    ``ds.T.astype(do.dtype)``); float32 sums of the rounded values."""
    q, _, g, p, ds = _grads_of_scores(qh, kh, vh, dout, lse, di)
    dk = torch.matmul(_rounded(ds, qh.dtype).transpose(-1, -2), q)
    dv = torch.matmul(_rounded(p, qh.dtype).transpose(-1, -2), g)
    return dk.to(qh.dtype), dv.to(qh.dtype)


def flash_attention_bwd_dq_plain(qh, kh, vh, dout, lse, di):
    """Plain version of the dQ kernel: dS K in q's type, dS rounded to q's
    type before the product (the library's ``ds.astype(k.dtype)``)."""
    _, k, _, _, ds = _grads_of_scores(qh, kh, vh, dout, lse, di)
    return torch.matmul(_rounded(ds, qh.dtype), k).to(qh.dtype)


def attention_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = Σ_e o·dO in float32, (B, H, T): plain torch on either device, as
    the library computes it outside its kernels."""
    return (out.float() * dout.float()).sum(-1)


def flash_attention_backward_plain(qh, kh, vh, out, lse, dout):
    """Plain backward of :func:`flash_attention_plain`: (dQ, dK, dV) from
    the forward's output and log-sum-exp, as the library's Pallas backward
    computes them (float32 sums; P and dS rounded to q's type before the
    products; the gradients rounded to q's type)."""
    di = attention_di(out, dout)
    dk, dv = flash_attention_bwd_dkv_plain(qh, kh, vh, dout, lse, di)
    return flash_attention_bwd_dq_plain(qh, kh, vh, dout, lse, di), dk, dv


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bwd_launcher(entry: str, pointers: int):
    """Build and load ``flash_attention_bwd.cu`` (first call only) and type
    one of its launchers: ``pointers`` tensors, then bh, t, dh, the bf16
    flag and the stream."""
    fn = getattr(build.load("flash_attention_bwd"), entry)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie on
    one CUDA device otherwise."""
    if all(x.device.type == "cpu" for x in xs):
        return True
    if not all(x.device.type == "cuda" and x.device == xs[0].device for x in xs):
        raise ValueError(f"flash attention runs on one CUDA device or the CPU, got "
                         f"{', '.join(str(x.device) for x in xs)}")
    return False


def _check(name: str, qh: torch.Tensor, *rest: torch.Tensor) -> None:
    """The kernels' shared contract on (B, H, T, Dh) tensors of one type."""
    if qh.ndim != 4 or any(x.shape != qh.shape for x in rest):
        raise ValueError(f"{name} wants tensors of one (B, H, T, Dh) shape, got "
                         f"{', '.join(str(tuple(x.shape)) for x in (qh, *rest))}")
    if qh.dtype not in (torch.bfloat16, torch.float32) or any(x.dtype != qh.dtype
                                                              for x in rest):
        raise TypeError(f"{name} wants bfloat16 or float32 tensors of one type, got "
                        f"{', '.join(str(x.dtype) for x in (qh, *rest))}")


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name} wants contiguous tensors")
    b, h, _, dh = xs[0].shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} unsupported (one of {HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} above the grid's 65535")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name} wants 16-byte aligned tensors (TMA, float4 loads)")


def _raise_on(name: str, rc: int) -> None:
    """Raises for a launcher's non-zero return: a cudaError_t, or 1000 + the
    CUresult of a failed tensor-map encode."""
    if rc != 0:
        what = (f"cuTensorMapEncodeTiled CUresult {rc - 1000}" if rc > 1000
                else f"cudaError {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {what}")


def _flash_forward(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                   with_lse: bool):
    """The forward on the tensors' device: (out, lse or None)."""
    _check("flash_attention", qh, kh, vh)
    if _on_cpu(qh, kh, vh):
        if with_lse:
            return flash_attention_plain(qh, kh, vh, with_lse=True)
        return flash_attention_plain(qh, kh, vh), None
    _check_cuda("flash_attention", qh, kh, vh)
    b, h, t, dh = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=qh.device) if with_lse else None
    if b * h * t == 0:
        return out, lse
    launch = _launcher(qh.dtype)
    extra = (plan_f32(b * h, t, _sm_count(qh.device)),) if qh.dtype == torch.float32 else ()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = launch(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b * h, t, dh, *extra, stream)
    _raise_on("flash_attention", rc)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """flash_attention under grad: the forward keeps (q, k, v, out, lse),
    the backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        out, lse = _flash_forward(qh, kh, vh, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        return flash_attention_backward(qh, kh, vh, out, lse, dout.contiguous())


def flash_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Non-causal self-attention over (B, H, T, Dh) q/k/v (q and k
    pre-scaled) -> (B, H, T, Dh) in q's type. CPU tensors take the plain
    version; CUDA tensors the kernel body of their type (bf16 or float32).
    Under grad it is differentiable, through the backward kernels."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qh, kh, vh)):
        return _FlashAttention.apply(qh, kh, vh)
    return _flash_forward(qh, kh, vh, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_with_lse(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor):
    """The forward and each row's float32 log-sum-exp, (B, H, T): the
    kernel's on the card, the plain version's on the CPU (no grad)."""
    return _flash_forward(qh, kh, vh, with_lse=True)


def _bwd_args(name: str, qh, kh, vh, dout, lse, di):
    _check(name, qh, kh, vh, dout)
    b, h, t, _ = qh.shape
    if lse.shape != (b, h, t) or di.shape != (b, h, t) \
            or lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError(f"{name} wants float32 lse and di of shape {(b, h, t)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}, {di.dtype} {tuple(di.shape)}")
    cpu = _on_cpu(qh, kh, vh, dout, lse, di)
    if not cpu:
        _check_cuda(name, qh, kh, vh, dout)
        if not (lse.is_contiguous() and di.is_contiguous()):
            raise ValueError(f"{name} wants contiguous lse and di")
    return cpu


def flash_attention_bwd_dkv(qh, kh, vh, dout, lse, di):
    """(dK, dV) of :func:`flash_attention` from (B, H, T, Dh) q, k, v, dO and
    the forward's (B, H, T) float32 lse, with di = Σ(o·dO): the dK/dV
    kernel on the card, :func:`flash_attention_bwd_dkv_plain` on the CPU."""
    if _bwd_args("flash_attention_bwd_dkv", qh, kh, vh, dout, lse, di):
        return flash_attention_bwd_dkv_plain(qh, kh, vh, dout, lse, di)
    b, h, t, dh = qh.shape
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    if b * h * t == 0:
        return dk, dv
    launch = _bwd_launcher("flash_attention_bwd_dkv_launch", 8)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = launch(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    b * h, t, dh, int(qh.dtype == torch.bfloat16), stream)
    _raise_on("flash_attention_bwd_dkv", rc)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(qh, kh, vh, dout, lse, di):
    """dQ of :func:`flash_attention`, arguments as
    :func:`flash_attention_bwd_dkv`: the dQ kernel on the card,
    :func:`flash_attention_bwd_dq_plain` on the CPU."""
    if _bwd_args("flash_attention_bwd_dq", qh, kh, vh, dout, lse, di):
        return flash_attention_bwd_dq_plain(qh, kh, vh, dout, lse, di)
    b, h, t, dh = qh.shape
    dq = torch.empty_like(qh)
    if b * h * t == 0:
        return dq
    launch = _bwd_launcher("flash_attention_bwd_dq_launch", 7)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = launch(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                    b * h, t, dh, int(qh.dtype == torch.bfloat16), stream)
    _raise_on("flash_attention_bwd_dq", rc)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_backward(qh, kh, vh, out, lse, dout):
    """(dQ, dK, dV) of :func:`flash_attention` from the forward's output and
    log-sum-exp: di in plain torch, then the two backward wrappers."""
    di = attention_di(out, dout)
    dk, dv = flash_attention_bwd_dkv(qh, kh, vh, dout, lse, di)
    return flash_attention_bwd_dq(qh, kh, vh, dout, lse, di), dk, dv


__all__ = ["HEAD_DIMS", "attention_di", "f32_waves", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_plain", "flash_attention_with_lse", "plan_f32"]
