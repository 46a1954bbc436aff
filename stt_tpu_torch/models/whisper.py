"""Whisper encoder/decoder in PyTorch with KV-cached greedy decoding.

Counterpart of ``stt_tpu/models/whisper.py`` for the serving step at
beam 1 without timestamps. Layouts and numerics follow the JAX package so
that the two can be held against each other on identical weights:

- Parameters keep the JAX layouts (linear weights (d_in, d_out), conv
  kernels (K, C_in, C_out)); :func:`init_params` draws them with the same
  numpy generator calls, so a seed gives bit-identical weights in both
  packages. ``stt_tpu_torch.convert`` maps the JAX tree onto the modules.
- Layer norm takes float32 statistics (eps 1e-5); linear layers
  accumulate in float32 and add the bias before rounding to the compute
  type (``addmm``); attention logits, softmax and the weighted mix run in
  float32, with the softmax weights rounded to the compute type first,
  as the JAX package's ``preferred_element_type=float32`` einsums do.
- The KV caches are head-split with k pre-scaled by ``d_head**-0.25``.
  Under bfloat16 compute the cross K/V is stored int8 with per-(layer,
  row, head) scales (the default, folded into q and the output as in
  ``_cross_layer_attn``), fp8 e4m3 or bf16, as :class:`AttentionPolicy`
  says.
- :class:`AttentionPolicy` holds the three attention options the JAX
  package reads from its environment at import (``STT_CROSS_KV_DTYPE``,
  ``STT_XATTN_KERNEL``, ``STT_FLASH_ATTENTION``); :func:`build_model`
  gives it to the model. With the cross-attention kernel on, every
  single-position decode step's cross-attention goes through
  :func:`~stt_tpu_torch.ops.kernels.xattn_decode.xattn_decode`; with flash
  on, unmasked self-attention of 512 positions or more (the encoder at the
  30 s bucket) goes through
  :func:`~stt_tpu_torch.ops.kernels.flash_attention.flash_attention`. Both
  wrappers launch their CUDA kernel on the card and take their plain
  version on the CPU.

The decode step has one shape for every position, as the JAX package's
scalar-``pos`` ``_decoder_step``: ``pos`` is a 0-d device tensor, the
embeddings are gathered by index, the new K/V are written with
``index_copy_`` and self-attention runs over every cache slot under the
mask ``slot <= pos``. Unlike the JAX package, the caches and the decode
state (:class:`DecodeState`) are updated in place, and the greedy loop is
split: the prefill runs once, then :func:`_decode_chunk` runs
``FINISH_CHECK_EVERY`` steps that read and write only the state's buffers,
and the host reads all-rows-finished once after each chunk. Extra steps
after every row has finished only rewrite end-of-text tokens, so the
result is the JAX package's. No step reads a value back to the host, so
the card can capture a chunk once as a CUDA graph and replay it
(``stt_tpu_torch/engine/graphs.py``); on the CPU the same function runs
uncaptured.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..convert import from_jax_params
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.xattn_decode import xattn_decode
from .presets import (  # noqa: F401
    WHISPER_LANG_CODES,
    TokenLayout,
    WhisperConfig,
    get_config,
    token_layout,
)

# ---------------------------------------------------------------------------
# Attention policy
# ---------------------------------------------------------------------------

# self-attention of at least this many positions can take the flash kernel
# (stt_tpu/models/whisper.py:_FLASH_MIN_SEQ); of the audio buckets only 30 s
# (1500 encoder positions) reaches it
FLASH_MIN_SEQ = 512

_FP8_NAMES = ("fp8", "f8", "float8", "fp8_e4m3")
_INT8_NAMES = ("int8", "i8")
_OFF_NAMES = ("off", "0", "false")
# option -> (environment variable, default): the JAX package's names
POLICY_ENV = {
    "cross_kv_dtype": ("STT_CROSS_KV_DTYPE", "int8"),
    "xattn_kernel": ("STT_XATTN_KERNEL", "off"),
    "flash_attention": ("STT_FLASH_ATTENTION", "off"),
}


@dataclass(frozen=True)
class AttentionPolicy:
    """The attention options, each meaning what it means in the JAX package:

    - ``cross_kv_dtype``: cross K/V storage under bfloat16 compute —
      ``fp8``/``f8``/``float8``/``fp8_e4m3`` store fp8 e4m3,
      ``int8``/``i8`` int8 with per-(row, head) scales, anything else the
      compute type; under float32 compute storage is always float32;
    - ``xattn_kernel``: ``off``/``0``/``false`` keep the einsum; any other
      value sends single-position cross-attention to the kernel;
    - ``flash_attention``: ``off`` keeps the einsum; any other value sends
      unmasked self-attention of ``FLASH_MIN_SEQ`` positions or more to the
      flash kernel.

    Values are compared stripped and lower-cased.
    """

    cross_kv_dtype: str = "int8"
    xattn_kernel: str = "off"
    flash_attention: str = "off"

    def __post_init__(self) -> None:
        for name in POLICY_ENV:
            object.__setattr__(self, name, str(getattr(self, name)).strip().lower())

    @classmethod
    def from_env(cls, **given: Optional[str]) -> "AttentionPolicy":
        """The policy from explicit values; each one left None is read from
        its environment variable (``POLICY_ENV``), with the JAX default."""
        values = {}
        for name, (var, default) in POLICY_ENV.items():
            value = given.pop(name, None)
            values[name] = os.environ.get(var, default) if value is None else value
        if given:
            raise TypeError(f"unknown attention options {sorted(given)}")
        return cls(**values)

    def cross_store_dtype(self, compute_dtype: torch.dtype) -> Optional[torch.dtype]:
        """Storage type of the cross K/V, or None for the compute type
        (``stt_tpu/models/whisper.py:_cross_store_dtype``)."""
        if compute_dtype != torch.bfloat16:
            return None
        if self.cross_kv_dtype in _FP8_NAMES:
            return torch.float8_e4m3fn
        if self.cross_kv_dtype in _INT8_NAMES:
            return torch.int8
        return None

    @property
    def xattn_on(self) -> bool:
        return self.xattn_kernel not in _OFF_NAMES

    def flash_on(self, seq_len: int) -> bool:
        return self.flash_attention != "off" and seq_len >= FLASH_MIN_SEQ


# ---------------------------------------------------------------------------
# Parameter init (numpy, bit-identical to the JAX package)
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    assert channels % 2 == 0
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _init_block(rng: np.random.Generator, d: int, cross: bool) -> Dict[str, Any]:
    def lin(n_in, n_out, bias=True):
        w = rng.normal(0.0, n_in**-0.5, (n_in, n_out)).astype(np.float32)
        out = {"w": w}
        if bias:
            out["b"] = np.zeros(n_out, np.float32)
        return out

    def ln():
        return {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)}

    block = {
        "ln1": ln(),
        "attn": {
            "q": lin(d, d), "k": lin(d, d, bias=False),
            "v": lin(d, d), "o": lin(d, d),
        },
        "ln2": ln(),
        "mlp": {"fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)},
    }
    if cross:
        block["ln_x"] = ln()
        block["xattn"] = {
            "q": lin(d, d), "k": lin(d, d, bias=False),
            "v": lin(d, d), "o": lin(d, d),
        }
    return block


def _stack_blocks(blocks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of per-layer dicts -> single dict with (L, ...) leaves."""
    first = blocks[0]
    return {
        k: _stack_blocks([b[k] for b in blocks]) if isinstance(v, dict)
        else np.stack([b[k] for b in blocks])
        for k, v in first.items()
    }


def init_params(config: WhisperConfig, seed: int = 0) -> Dict[str, Any]:
    """Deterministic random parameters with the checkpoint structure, as a
    JAX-layout tree of float32 numpy arrays (the JAX package's
    ``init_params`` draws the same numbers from the same seed)."""
    rng = np.random.default_rng(seed)
    d_a, d_t = config.n_audio_state, config.n_text_state

    enc = {
        "conv1": {
            "w": rng.normal(0, (3 * config.n_mels) ** -0.5,
                            (3, config.n_mels, d_a)).astype(np.float32),
            "b": np.zeros(d_a, np.float32),
        },
        "conv2": {
            "w": rng.normal(0, (3 * d_a) ** -0.5, (3, d_a, d_a)).astype(np.float32),
            "b": np.zeros(d_a, np.float32),
        },
        "pos": _sinusoids(config.n_audio_ctx, d_a),
        "blocks": _stack_blocks(
            [_init_block(rng, d_a, cross=False) for _ in range(config.n_audio_layer)]
        ),
        "ln_post": {"g": np.ones(d_a, np.float32), "b": np.zeros(d_a, np.float32)},
    }
    dec = {
        "tok": rng.normal(0, 0.02, (config.n_vocab, d_t)).astype(np.float32),
        "pos": rng.normal(0, 0.01, (config.n_text_ctx, d_t)).astype(np.float32),
        "blocks": _stack_blocks(
            [_init_block(rng, d_t, cross=True) for _ in range(config.n_text_layer)]
        ),
        "ln": {"g": np.ones(d_t, np.float32), "b": np.zeros(d_t, np.float32)},
    }
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# Modules (parameter names mirror the JAX tree)
# ---------------------------------------------------------------------------


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True) -> None:
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self)


class LayerNorm(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.g = _param(d)
        self.b = _param(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self)


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.w = _param(3, c_in, c_out)
        self.b = _param(c_out)


class Attention(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.q = Linear(d, d)
        self.k = Linear(d, d, bias=False)
        self.v = Linear(d, d)
        self.o = Linear(d, d)


class MLP(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.fc1 = Linear(d, 4 * d)
        self.fc2 = Linear(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, d: int, cross: bool) -> None:
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.attn = Attention(d)
        self.ln2 = LayerNorm(d)
        self.mlp = MLP(d)
        if cross:
            self.ln_x = LayerNorm(d)
            self.xattn = Attention(d)


class AudioEncoder(nn.Module):
    def __init__(self, config: WhisperConfig,
                 policy: AttentionPolicy = AttentionPolicy()) -> None:
        super().__init__()
        d = config.n_audio_state
        self.n_head = config.n_audio_head
        self.policy = policy
        self.conv1 = Conv(config.n_mels, d)
        self.conv2 = Conv(d, d)
        self.pos = _param(config.n_audio_ctx, d)
        self.blocks = nn.ModuleList(
            Block(d, cross=False) for _ in range(config.n_audio_layer)
        )
        self.ln_post = LayerNorm(d)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, T_frames) -> encoder states (B, T_frames//2, d)."""
        x = mel.transpose(1, 2)  # (B, T, n_mels)
        x = F.gelu(_conv1d(x, self.conv1, 1))
        x = F.gelu(_conv1d(x, self.conv2, 2))
        x = x + self.pos[: x.shape[1]].to(x.dtype)
        for block in self.blocks:
            x = x + _self_attn(block.ln1(x), block.attn, self.n_head,
                               flash=self.policy.flash_on(x.shape[1]))
            x = x + block.mlp(block.ln2(x))
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, config: WhisperConfig,
                 policy: AttentionPolicy = AttentionPolicy()) -> None:
        super().__init__()
        d = config.n_text_state
        self.n_head = config.n_text_head
        self.policy = policy
        self.tok = _param(config.n_vocab, d)
        self.pos = _param(config.n_text_ctx, d)
        self.blocks = nn.ModuleList(
            Block(d, cross=True) for _ in range(config.n_text_layer)
        )
        self.ln = LayerNorm(d)
        self._tok_f32: Optional[torch.Tensor] = None

    def tok_f32(self) -> torch.Tensor:
        """The token table in float32 for the tied logits product (made
        once under a narrower compute type; the weights are fixed after
        loading). Its values are the stored ones, so the float32 product
        equals the JAX package's float32-accumulated one."""
        if self.tok.dtype == torch.float32:
            return self.tok
        if self._tok_f32 is None or self._tok_f32.device != self.tok.device:
            self._tok_f32 = self.tok.float()
        return self._tok_f32


class Whisper(nn.Module):
    def __init__(self, config: WhisperConfig,
                 policy: AttentionPolicy = AttentionPolicy()) -> None:
        super().__init__()
        self.config = config
        self.encoder = AudioEncoder(config, policy)
        self.decoder = TextDecoder(config, policy)


def build_model(
    config: WhisperConfig,
    params: Dict[str, Any],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    policy: AttentionPolicy = AttentionPolicy(),
) -> Whisper:
    """Whisper module on ``device`` in ``dtype`` from a JAX-layout tree
    (e.g. :func:`init_params`) under the attention ``policy``; no float32
    copy is made on the host."""
    with torch.device("meta"):
        model = Whisper(config, policy)
    model.load_state_dict(from_jax_params(params), strict=True, assign=True)
    model = model.to(device=device, dtype=dtype)
    model.requires_grad_(False)
    return model.eval()


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: LayerNorm) -> torch.Tensor:
    return F.layer_norm(
        x.float(), (x.shape[-1],), p.g.float(), p.b.float(), 1e-5
    ).to(x.dtype)


def _linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    if p.b is None:
        return torch.matmul(x, p.w)
    y = torch.addmm(p.b, x.reshape(-1, x.shape[-1]), p.w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape  # (B, T, d) -> (B, H, T, Dh)
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape  # (B, H, T, Dh) -> (B, T, d)
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attn_cached(qh, kh, vh, mask=None) -> torch.Tensor:
    """Attention over pre-split, pre-scaled q and K: qh (B, H, Tq, Dh),
    kh/vh (B, H, Tk, Dh), possibly stored narrower (int8 cross K/V).
    float32 logits and softmax; the weights round to q's type before the
    float32 mix. Returns float32 (B, H, Tq, Dh)."""
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1).to(qh.dtype)
    return torch.matmul(weights.float(), vh.to(qh.dtype).float())


def _attention(q, k, v, n_head: int, mask=None, flash: bool = False) -> torch.Tensor:
    """q: (B, Tq, d); k/v: (B, Tk, d). q and k each scaled by
    d_head**-0.25, as whisper. With ``flash`` (the policy's choice at this
    length), unmasked self-attention goes through the flash wrapper: its
    kernel on the card, its plain version on the CPU."""
    scale = (q.shape[-1] // n_head) ** -0.25
    qh = _split_heads(q, n_head) * scale
    kh = _split_heads(k, n_head) * scale
    vh = _split_heads(v, n_head)
    if flash and mask is None and q.shape[1] == k.shape[1]:
        return _merge_heads(flash_attention(qh.contiguous(), kh.contiguous(),
                                            vh.contiguous()))
    return _merge_heads(_attn_cached(qh, kh, vh, mask).to(q.dtype))


def _self_attn(x, p: Attention, n_head: int, mask=None, flash: bool = False) -> torch.Tensor:
    return p.o(_attention(p.q(x), p.k(x), p.v(x), n_head, mask, flash))


def _conv1d(x: torch.Tensor, p: Conv, stride: int) -> torch.Tensor:
    """x (B, T, C_in), kernel (3, C_in, C_out), padding 1 -> (B, T', C_out)."""
    w = p.w.to(x.dtype).permute(2, 1, 0)  # (C_out, C_in, K)
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=1)
    return y.transpose(1, 2) + p.b.to(x.dtype)


# ---------------------------------------------------------------------------
# Decoder with KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Self-attention cache, head-split: (L, B, H, T_max, Dh) post-projection
    k and v, k pre-scaled by d_head**-0.25. Written in place."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(config: WhisperConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    h = config.n_text_head
    shape = (config.n_text_layer, batch, h, max_len, config.n_text_state // h)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class CrossKV(NamedTuple):
    """Cross-attention K/V for all layers, head-split, k pre-scaled:
    (L, B, H, T_audio, Dh) in the storage type (int8, fp8 e4m3, or the
    compute type). ``k_scale``/``v_scale`` are the per-(layer, row, head)
    dequant scales (L, B, H, 1, 1) float32 when storage is int8, else
    None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]


def _q8(x: torch.Tensor):
    """Symmetric int8 with one scale per (row, head) over (T, Dh)."""
    xf = x.float()
    s = torch.clamp_min(torch.amax(torch.abs(xf), dim=(2, 3), keepdim=True) / 127.0, 1e-12)
    return torch.round(xf / s).to(torch.int8), s


def empty_cross_kv(dec: TextDecoder, batch: int, n_audio: int,
                   dtype: torch.dtype, device: torch.device) -> CrossKV:
    """Zeroed cross K/V buffers for ``batch`` rows of ``n_audio`` encoder
    positions under compute type ``dtype``, in the storage the decoder's
    policy picks (with int8 scales): an ``out=`` for
    :func:`precompute_cross_kv`."""
    n_head = dec.n_head
    d = dec.tok.shape[1]
    shape = (len(dec.blocks), batch, n_head, n_audio, d // n_head)
    store = dec.policy.cross_store_dtype(dtype) or dtype
    scales = None
    if store == torch.int8:
        scales = [torch.zeros(shape[:3] + (1, 1), dtype=torch.float32, device=device)
                  for _ in range(2)]
    return CrossKV(torch.zeros(shape, dtype=store, device=device),
                   torch.zeros(shape, dtype=store, device=device),
                   *(scales or (None, None)))


def precompute_cross_kv(dec: TextDecoder, enc_out: torch.Tensor,
                        out: Optional[CrossKV] = None) -> CrossKV:
    """Cross-attention K/V for all layers, computed once per window, stored
    as the decoder's policy says: int8 with per-(layer, row, head) scales
    or fp8 e4m3 (both only under bfloat16 compute), else the compute type.
    fp8 is cast from the bf16 k·Dh^-0.25 and v, as the JAX package casts
    it; beyond ±464 torch's cast saturates to ±448 where JAX's gives NaN,
    and the port keeps torch's. With ``out`` (buffers of
    :func:`empty_cross_kv`'s shape) each layer is written into it in place
    and ``out`` is returned."""
    n_head = dec.n_head
    scale = (enc_out.shape[-1] // n_head) ** -0.25
    store = dec.policy.cross_store_dtype(enc_out.dtype)
    int8 = store == torch.int8
    ks, vs, kss, vss = [], [], [], []
    for li, block in enumerate(dec.blocks):
        k = _split_heads(block.xattn.k(enc_out), n_head) * scale
        v = _split_heads(block.xattn.v(enc_out), n_head)
        k_s = v_s = None
        if int8:
            (k, k_s), (v, v_s) = _q8(k), _q8(v)
        elif store is not None:
            k, v = k.to(store), v.to(store)
        if out is not None:
            out.k[li].copy_(k)
            out.v[li].copy_(v)
            if int8:
                out.k_scale[li].copy_(k_s)
                out.v_scale[li].copy_(v_s)
            continue
        ks.append(k)
        vs.append(v)
        kss.append(k_s)
        vss.append(v_s)
    if out is not None:
        return out
    return CrossKV(
        torch.stack(ks), torch.stack(vs),
        torch.stack(kss) if int8 else None, torch.stack(vss) if int8 else None,
    )


def _cross_dequant(ckv: CrossKV):
    """(k, v) in the compute type, materialised — for the one-shot
    teacher-forced pass only; the decode loop reads storage through
    :func:`_cross_layer_attn`."""
    if ckv.k_scale is None:
        return ckv.k, ckv.v
    k = ckv.k.to(torch.bfloat16) * ckv.k_scale.to(torch.bfloat16)
    v = ckv.v.to(torch.bfloat16) * ckv.v_scale.to(torch.bfloat16)
    return k, v


def _cross_layer_attn(qx: torch.Tensor, ckv: CrossKV, li: int,
                      kernel: bool = False) -> torch.Tensor:
    """Cross-attention for one layer against the stored K/V. int8 storage
    folds the per-(row, head) scales into q and the output — logits =
    (q*ks)·kq and out = (w·vq)*vs are exact since each scale is one
    number per (row, head) — so the large K/V are only converted. With
    ``kernel`` a single-position query (Tq == 1) goes through the
    cross-attention decode wrapper for every storage: its kernel on the
    card, its plain version on the CPU."""
    ck, cv = ckv.k[li], ckv.v[li]
    if ckv.k_scale is not None:
        qx = qx * ckv.k_scale[li].to(qx.dtype)
    if kernel and qx.shape[2] == 1:
        out = xattn_decode(qx[:, :, 0, :].contiguous(), ck, cv)[:, :, None, :]
    else:
        out = _attn_cached(qx, ck, cv)
    return out if ckv.v_scale is None else out * ckv.v_scale[li]


def _tok_logits(dec: TextDecoder, x: torch.Tensor) -> torch.Tensor:
    """float32 vocab logits against the tied token table."""
    return F.linear(x.float(), dec.tok_f32())


def _decoder_step(dec: TextDecoder, tokens: torch.Tensor, pos: Union[int, torch.Tensor],
                  cache: KVCache, cross_kv: CrossKV) -> torch.Tensor:
    """One decode position for the whole batch at scalar position ``pos``
    (a 0-d int64 tensor on the tokens' device; a Python int is filled in
    there, with no host-to-device copy): tokens (B,) -> logits (B, V)
    float32. Writes k/v of ``pos`` into the cache in place and attends over
    all T_max slots under the mask ``slot <= pos``, as the JAX package's
    scalar-``pos`` step does. Every shape is the same at every position and
    nothing is read back to the host, so the step can be captured in a CUDA
    graph."""
    n_head = dec.n_head
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.long, device=tokens.device)
    slot = pos.reshape(1)
    h = (dec.tok[tokens] + dec.pos.index_select(0, slot).to(dec.tok.dtype))[:, None, :]
    scale = (h.shape[-1] // n_head) ** -0.25
    t_max = cache.k.shape[3]
    mask = torch.where(torch.arange(t_max, device=tokens.device) <= pos, 0.0, -torch.inf)
    for li, block in enumerate(dec.blocks):
        hn = block.ln1(h)
        qh = _split_heads(block.attn.q(hn), n_head) * scale
        k_new = _split_heads(block.attn.k(hn), n_head) * scale
        v_new = _split_heads(block.attn.v(hn), n_head)
        cache.k[li].index_copy_(2, slot, k_new.to(cache.k.dtype))
        cache.v[li].index_copy_(2, slot, v_new.to(cache.v.dtype))
        attn_out = _attn_cached(qh, cache.k[li], cache.v[li], mask).to(h.dtype)
        h = h + block.attn.o(_merge_heads(attn_out))
        qx = _split_heads(block.xattn.q(block.ln_x(h)), n_head) * scale
        x_out = _cross_layer_attn(qx, cross_kv, li, dec.policy.xattn_on).to(h.dtype)
        h = h + block.xattn.o(_merge_heads(x_out))
        h = h + block.mlp(block.ln2(h))
    return _tok_logits(dec, dec.ln(h)[:, 0, :])


def _causal_mask(width: int, device: torch.device) -> torch.Tensor:
    i = torch.arange(width, device=device)
    zero = torch.zeros((), device=device)
    return torch.where(i[None, :] <= i[:, None], zero, -torch.inf)[None, None]


def _prefill_parallel(dec: TextDecoder, tokens: torch.Tensor, width: int,
                      cache: KVCache, cross_kv: CrossKV) -> torch.Tensor:
    """Teacher-forced pass over positions [0, width): writes the cache
    contents of ``width`` sequential :func:`_decoder_step` calls in one
    batched pass. Returns pre-final-LN hidden states (B, width, d)."""
    n_head = dec.n_head
    h = dec.tok[tokens[:, :width]] + dec.pos[:width][None].to(dec.tok.dtype)
    scale = (h.shape[-1] // n_head) ** -0.25
    causal = _causal_mask(width, h.device)
    for li, block in enumerate(dec.blocks):
        hn = block.ln1(h)
        qh = _split_heads(block.attn.q(hn), n_head) * scale
        k_new = (_split_heads(block.attn.k(hn), n_head) * scale).to(cache.k.dtype)
        v_new = _split_heads(block.attn.v(hn), n_head).to(cache.v.dtype)
        cache.k[li, :, :, :width] = k_new
        cache.v[li, :, :, :width] = v_new
        attn_out = _attn_cached(qh, k_new, v_new, causal).to(h.dtype)
        h = h + block.attn.o(_merge_heads(attn_out))
        qx = _split_heads(block.xattn.q(block.ln_x(h)), n_head) * scale
        x_out = _cross_layer_attn(qx, cross_kv, li).to(h.dtype)
        h = h + block.xattn.o(_merge_heads(x_out))
        h = h + block.mlp(block.ln2(h))
    return h


def _prefill(dec: TextDecoder, tokens: torch.Tensor, p_len: int,
             cache: KVCache, cross_kv: CrossKV, sot_pos: int,
             layout: TokenLayout) -> torch.Tensor:
    """Fill cache positions [0, p_len - 1) (the loop processes the last
    prompt position) and return p(no_speech) read from the logits AT the
    sot position (openai ``DecodingTask._main_loop``)."""
    if p_len <= 1:
        return torch.zeros(tokens.shape[0], device=tokens.device)
    h = _prefill_parallel(dec, tokens, p_len - 1, cache, cross_kv)
    h_sot = h[:, sot_pos : sot_pos + 1]
    logits = _tok_logits(dec, dec.ln(h_sot)[:, 0, :])
    return torch.softmax(logits, dim=-1)[:, layout.no_speech]


def decoder_forward(model: Whisper, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """Full teacher-forced decoder pass: tokens (B, T) -> logits (B, T, V)."""
    dec = model.decoder
    n_head = dec.n_head
    t = tokens.shape[1]
    h = dec.tok[tokens] + dec.pos[:t][None].to(dec.tok.dtype)
    causal = _causal_mask(t, h.device)
    xk, xv = _cross_dequant(precompute_cross_kv(dec, enc_out))
    scale = (h.shape[-1] // n_head) ** -0.25
    for li, block in enumerate(dec.blocks):
        h = h + _self_attn(block.ln1(h), block.attn, n_head, causal)
        qx = _split_heads(block.xattn.q(block.ln_x(h)), n_head) * scale
        x_out = _merge_heads(_attn_cached(qx, xk[li], xv[li]).to(h.dtype))
        h = h + block.xattn.o(x_out)
        h = h + block.mlp(block.ln2(h))
    return _tok_logits(dec, dec.ln(h))


# ---------------------------------------------------------------------------
# Greedy decoding
# ---------------------------------------------------------------------------

BLANK_TOKEN = 220  # byte-level BPE id of " " (openai tokenizer.encode(" "))
# host syncs in the greedy loop: test for all-rows-finished every N steps
FINISH_CHECK_EVERY = 8


class DecodeResult(NamedTuple):
    tokens: torch.Tensor          # (B, T_max) int64, prompt + generated, eot-padded
    lengths: torch.Tensor         # (B,) total valid length incl. prompt
    sum_logprob: torch.Tensor     # (B,) sum of generated-token logprobs
    no_speech_prob: torch.Tensor  # (B,) p(no_speech) at the sot position


def _suppress_mask(config: WhisperConfig) -> np.ndarray:
    """Additive logit mask suppressing special/timestamp tokens (greedy,
    no-timestamps mode): every special except eot."""
    layout = token_layout(config.n_vocab)
    mask = np.zeros(config.n_vocab, np.float32)
    mask[layout.sot:] = -np.inf
    mask[layout.eot] = 0.0
    return mask


def _sample_begin_mask(config: WhisperConfig) -> np.ndarray:
    """Additive mask for the FIRST generated position under
    ``suppress_blank``: never start with a lone space or an eot."""
    layout = token_layout(config.n_vocab)
    mask = np.zeros(config.n_vocab, np.float32)
    mask[BLANK_TOKEN] = -np.inf
    mask[layout.eot] = -np.inf
    return mask


class DecodeState(NamedTuple):
    """Everything the greedy loop reads and writes, allocated once for a
    (rows, prompt length, max_new) shape and updated in place, so a CUDA
    graph of :func:`_decode_chunk` can be replayed against it. The masks
    are built once from numpy."""

    tokens: torch.Tensor       # (B, T_max) int64: prompt + generated, eot-padded
    cache: KVCache             # self-attention K/V, (L, B, H, T_max, Dh)
    pos: torch.Tensor          # () int64: the position the next step writes
    finished: torch.Tensor     # (B,) bool
    sum_lp: torch.Tensor       # (B,) float32: generated-token logprob sums
    prompt_len: torch.Tensor   # (B,) int64: each row's logical prompt length
    suppress: torch.Tensor     # (V,) float32: :func:`_suppress_mask`
    begin_blank: torch.Tensor  # (V,) float32: :func:`_sample_begin_mask`
    begin: torch.Tensor        # (V,) float32: ``begin_blank`` or zeros, per call


def init_decode_state(config: WhisperConfig, batch: int, p_len: int, max_new: int,
                      dtype: torch.dtype, device: torch.device) -> DecodeState:
    """Zeroed decode state for ``batch`` rows of a ``p_len``-token prompt
    and up to ``max_new`` generated tokens; the self cache is in ``dtype``."""
    t_max = p_len + max_new

    def const(mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(device)

    return DecodeState(
        tokens=torch.zeros((batch, t_max), dtype=torch.long, device=device),
        cache=init_kv_cache(config, batch, t_max, dtype, device),
        pos=torch.zeros((), dtype=torch.long, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        sum_lp=torch.zeros(batch, dtype=torch.float32, device=device),
        prompt_len=torch.zeros(batch, dtype=torch.long, device=device),
        suppress=const(_suppress_mask(config)),
        begin_blank=const(_sample_begin_mask(config)),
        begin=torch.zeros(config.n_vocab, dtype=torch.float32, device=device),
    )


def start_decode(dec: TextDecoder, state: DecodeState, prompt: torch.Tensor,
                 prompt_len: torch.Tensor, cross_kv: CrossKV, *,
                 suppress_blank: bool = True, sot_pos: int = 0) -> torch.Tensor:
    """Reset ``state`` for a new group: the prompt (B, P) right-padded with
    eot, eot past it, position P, no row finished; then the prefill fills
    cache positions [0, P - 1). Returns p(no_speech) at ``sot_pos``."""
    layout = token_layout(dec.tok.shape[0])
    p_len = prompt.shape[1]
    state.tokens.fill_(layout.eot)
    state.tokens[:, :p_len].copy_(prompt)
    state.prompt_len.copy_(prompt_len)
    state.pos.fill_(p_len)
    state.finished.zero_()
    state.sum_lp.zero_()
    if suppress_blank:
        state.begin.copy_(state.begin_blank)
    else:
        state.begin.zero_()
    return _prefill(dec, state.tokens, p_len, state.cache, cross_kv, sot_pos, layout)


def _decode_chunk(dec: TextDecoder, state: DecodeState, cross_kv: CrossKV,
                  n_steps: int = FINISH_CHECK_EVERY) -> None:
    """``n_steps`` greedy steps on ``state`` in place, reading and writing
    only its buffers and ``cross_kv`` (no host read, no allocation that
    outlives the call): the body of the JAX package's ``greedy_decode``
    while-loop, ``n_steps`` times. The caller keeps ``pos + n_steps`` within
    the state's T_max."""
    eot = token_layout(dec.tok.shape[0]).eot
    pos = state.pos
    for _ in range(n_steps):
        last = state.tokens.index_select(1, pos.reshape(1) - 1)[:, 0]
        logits = _decoder_step(dec, last, pos - 1, state.cache, cross_kv)
        logits = logits + state.suppress + torch.where(
            (state.prompt_len == pos)[:, None], state.begin, 0.0
        )
        logprobs = torch.log_softmax(logits, dim=-1)
        next_tok = torch.where(state.finished, eot, torch.argmax(logits, dim=-1))
        tok_lp = torch.gather(logprobs, 1, next_tok[:, None])[:, 0]
        state.sum_lp.add_(torch.where(state.finished, 0.0, tok_lp))
        state.tokens.index_copy_(1, pos.reshape(1), next_tok[:, None])
        state.finished.logical_or_(next_tok == eot)
        pos.add_(1)


def finish_decode(state: DecodeState, p_len: int,
                  no_speech_prob: torch.Tensor) -> DecodeResult:
    """The result of a decode on ``state``, copied out of its buffers:
    length = index of the first eot at/after the prompt, or ``pos`` if a
    row has none (the JAX package's ``first_eot``)."""
    tokens = state.tokens
    b, t_max = tokens.shape
    eot = token_layout(state.suppress.shape[0]).eot
    is_eot = (tokens == eot) & (torch.arange(t_max, device=tokens.device)[None, :] >= p_len)
    first_eot = torch.where(is_eot.any(dim=1), torch.argmax(is_eot.to(torch.int32), dim=1),
                            state.pos.expand(b))
    return DecodeResult(tokens.clone(), first_eot, state.sum_lp.clone(), no_speech_prob)


def greedy_decode(
    model: Whisper,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    max_new_tokens: int,
    *,
    suppress_blank: bool = True,
    sot_pos: int = 0,
    cross_kv: Optional[CrossKV] = None,
) -> DecodeResult:
    """Batched greedy decode with per-row early stop, uncaptured.

    prompt: (B, P) integer, right-padded with eot past ``prompt_len``;
    enc_out: (B, T_a, d). Same contract as the JAX package's
    ``greedy_decode`` without repetition penalty or n-gram bans. Runs
    chunks of ``FINISH_CHECK_EVERY`` steps (the last one shorter when
    ``max_new_tokens`` is not a multiple) and stops after the first chunk
    that leaves every row finished.
    """
    dec = model.decoder
    device = enc_out.device
    b, p_len = prompt.shape
    state = init_decode_state(model.config, b, p_len, max_new_tokens, enc_out.dtype, device)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(dec, enc_out)
    no_speech_prob = start_decode(
        dec, state, prompt.to(device=device, dtype=torch.long), prompt_len.to(device),
        cross_kv, suppress_blank=suppress_blank, sot_pos=sot_pos,
    )
    for done in range(0, max_new_tokens, FINISH_CHECK_EVERY):
        _decode_chunk(dec, state, cross_kv, min(FINISH_CHECK_EVERY, max_new_tokens - done))
        if bool(state.finished.all()):
            break
    return finish_decode(state, p_len, no_speech_prob)


def detect_language(model: Whisper, enc_out: torch.Tensor,
                    cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
    """(B, n_langs) language probabilities from the sot logits."""
    config = model.config
    layout = token_layout(config.n_vocab)
    b = enc_out.shape[0]
    if cross_kv is None:
        cross_kv = precompute_cross_kv(model.decoder, enc_out)
    cache = init_kv_cache(config, b, 4, enc_out.dtype, enc_out.device)
    sot = torch.full((b,), layout.sot, dtype=torch.long, device=enc_out.device)
    logits = _decoder_step(model.decoder, sot, 0, cache, cross_kv)
    lang_logits = logits[:, layout.lang_begin : layout.lang_begin + layout.n_langs]
    return torch.softmax(lang_logits, dim=-1)


def build_prompt(
    config: WhisperConfig,
    language: Optional[str],
    task: str = "transcribe",
    without_timestamps: bool = True,
) -> list:
    """SOT sequence: [sot, lang, task, (no_timestamps)]."""
    layout = token_layout(config.n_vocab)
    lang = language if language in WHISPER_LANG_CODES else "en"
    lang_token = layout.lang_begin + WHISPER_LANG_CODES.index(lang)
    task_token = layout.translate if task == "translate" else layout.transcribe
    prompt = [layout.sot, lang_token, task_token]
    if without_timestamps:
        prompt.append(layout.no_timestamps)
    return prompt


__all__ = [
    "AttentionPolicy",
    "CrossKV",
    "DecodeResult",
    "DecodeState",
    "KVCache",
    "TokenLayout",
    "WHISPER_LANG_CODES",
    "Whisper",
    "WhisperConfig",
    "build_model",
    "build_prompt",
    "decoder_forward",
    "detect_language",
    "empty_cross_kv",
    "finish_decode",
    "get_config",
    "greedy_decode",
    "init_decode_state",
    "init_kv_cache",
    "init_params",
    "precompute_cross_kv",
    "start_decode",
    "token_layout",
]
