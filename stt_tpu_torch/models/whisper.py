"""Whisper encoder/decoder in PyTorch with KV-cached greedy decoding, beam
search and the drafted greedy decode of streaming partials.

Counterpart of ``stt_tpu/models/whisper.py`` for the serving step without
timestamps, greedy at beam 1 and beam search above it. Layouts and
numerics follow the JAX package so that the two can be held against each
other on identical weights:

- Parameters keep the JAX layouts (linear weights (d_in, d_out), conv
  kernels (K, C_in, C_out)); :func:`init_params` draws them with the same
  numpy generator calls, so a seed gives bit-identical weights in both
  packages, and :func:`load_hf_safetensors` reads an HF checkpoint into
  the same tree. ``stt_tpu_torch.convert`` maps the JAX tree onto the
  modules.
- Layer norm takes float32 statistics (eps 1e-5); linear layers
  accumulate in float32 and add the bias before rounding to the compute
  type (``addmm``); the attention products and the vocabulary logits take
  operands in the compute type and give float32 (on the card the
  ``out_dtype`` overloads of ``bmm``/``mm``; on the CPU, which has no
  kernel for them, upcast operands), with softmax in float32 and its
  weights rounded to the compute type first, as the JAX package's
  ``preferred_element_type=float32`` einsums do. Stored K/V narrower than
  the compute type (int8, fp8) are converted to it, exactly, and no
  further; no float32 copy of a cache or of the token table is made. A
  single-position query over int8 cross K/V takes products that convert
  the codes as they load them on the card (``_attn_int8_codes``), as the
  JAX package's XLA einsum does, so no widened copy is made either.
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

:class:`DecoderPolicy` holds the decoder's four opt-in policies of the JAX
package (``STT_DECODER_WEIGHTS_DTYPE``, ``STT_FUSED_QKV``,
``STT_SELF_KV_DTYPE``, ``STT_PREFILL``), resolved for one compute type:
:func:`build_model` fuses the self-attention q/k/v (:func:`fuse_decoder_qkv`)
and then quantises the decoder's linears and token table to int8
(:func:`quantize_decoder_weights`, bfloat16 only) on the converted weights;
:func:`_linear` and :func:`_tok_logits` widen the int8 codes in the product
or, on the native route, multiply int8 codes with int32 accumulation
(:func:`_int8_mm`); the self cache is stored fp8 under ``self_kv`` fp8
(written through its bytes, :func:`_raw`); :func:`_prefill` takes one
decode step a position under ``prefill`` seq.

:func:`build_model`'s modules serve frozen; the trainer
(``stt_tpu_torch/parallel/trainer.py``) turns grads on in a module of its
own. The encoder and :func:`decoder_forward` write nothing in place, so
autograd runs through them, and flash attention under grad goes through
its autograd Function (the backward kernels on the card). A linear layer
or MLP split over a mesh's model axis computes from its shards through its
``shard`` hook (``stt_tpu_torch/parallel/collectives.py``).

:func:`cross_attention_weights` is the word-timestamp pass: the last two
decoder layers' float32 cross-attention maps over a teacher-forced
sequence (it runs under every policy, fused included, where the JAX
package's own pass reads the separate projections).

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

Beam search (:func:`beam_decode`, the ``accurate`` profile) is split the
same way over a :class:`BeamState` of rows x beams: :func:`start_beam`,
then :func:`_beam_chunk` (the frozen-slot search, or the pooled one when
patience asks for more finished candidates than beams), then
:func:`finish_beam`. The host reads the JAX loop's condition
(:func:`beam_running`) once a chunk; since each step is gated on that
condition on the device, steps past the stop change nothing. The top-K
keeps ``lax.top_k``'s order among equal scores (:func:`_top_k`).

The drafted decode (:func:`greedy_decode_drafted`) is split the same way
over a :class:`DraftState`: :func:`start_drafted` verifies a per-row draft
in one teacher-forced pass, accepts the longest prefix greedy would have
written and commits greedy's token at the first mismatch; then
:func:`_drafted_chunk` resumes every row at its own position (the step at
a vector of positions), every update of a finished row gated; then
:func:`finish_drafted`. It gives :func:`greedy_decode`'s tokens for any
draft in float32.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..convert import from_jax_params
from ..ops.kernels.cross_mm import cross_logits, cross_mix
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


_W8_NAMES = ("int8", "i8")
_W8_NATIVE_NAMES = ("int8_native", "i8n")
_ON_NAMES = ("1", "on", "true", "yes")
# switch -> default: the JAX package's names, read at its import
# (stt_tpu/models/whisper.py:353, 362, 504, 571)
DECODER_POLICY_ENV = {
    "weights": ("STT_DECODER_WEIGHTS_DTYPE", "bf16"),
    "fused_qkv": ("STT_FUSED_QKV", "off"),
    "self_kv": ("STT_SELF_KV_DTYPE", "bf16"),
    "prefill": ("STT_PREFILL", "parallel"),
}


@dataclass(frozen=True)
class DecoderPolicy:
    """The decoder's opt-in policies, resolved for one compute type, each
    meaning what its switch means in the JAX package:

    - ``weights``: ``bf16`` (the compute type), ``int8`` (symmetric int8
      storage with per-out-channel float32 scales, widened to the compute
      type in the product, the token table scaled per column) or
      ``int8_native`` (the same storage, and int8 x int8 products with int32
      accumulation against a per-row activation scale); int8 only under
      bfloat16 compute (``stt_tpu/models/whisper.py:571-626``);
    - ``fused_qkv``: the self-attention q/k/v projections as one (d, 3d)
      linear, k's absent bias a zero block (``:629-664``);
    - ``self_kv``: ``fp8`` stores the self-attention cache in fp8 e4m3
      (only under bfloat16 compute, ``:504-513``), else the compute type;
    - ``prefill``: ``seq`` fills the prompt's cache one decode step per
      position (``:952-993``), else in one teacher-forced pass.

    Frozen, so it keys the decode graphs; two engines of one process may
    hold different policies."""

    weights: str = "bf16"
    fused_qkv: bool = False
    self_kv: str = "bf16"
    prefill: str = "parallel"

    @classmethod
    def from_env(cls, compute_dtype: torch.dtype) -> "DecoderPolicy":
        """The policy for ``compute_dtype`` from the switches
        (``DECODER_POLICY_ENV``), each stripped and lower-cased and parsed
        as the JAX package parses it. int8 weights and the fp8 cache under
        float32 compute resolve to the compute type, as the JAX package
        ignores them there."""
        raw = {name: os.environ.get(var, default).strip().lower()
               for name, (var, default) in DECODER_POLICY_ENV.items()}
        bf16 = compute_dtype == torch.bfloat16
        weights = ("int8_native" if raw["weights"] in _W8_NATIVE_NAMES else
                   "int8" if raw["weights"] in _W8_NAMES else "bf16")
        return cls(
            weights=weights if bf16 else "bf16",
            fused_qkv=raw["fused_qkv"] in _ON_NAMES,
            self_kv="fp8" if bf16 and raw["self_kv"] in _FP8_NAMES else "bf16",
            prefill="seq" if raw["prefill"] == "seq" else "parallel",
        )

    @property
    def int8(self) -> bool:
        return self.weights != "bf16"

    @property
    def native(self) -> bool:
        return self.weights == "int8_native"

    def cache_dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        """Storage type of the self-attention cache
        (``stt_tpu/models/whisper.py:kv_cache_dtype``)."""
        if self.self_kv == "fp8" and compute_dtype == torch.bfloat16:
            return torch.float8_e4m3fn
        return compute_dtype


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


def load_hf_safetensors(path: str, config: Optional[WhisperConfig] = None,
                        ) -> Tuple[Dict[str, Any], WhisperConfig]:
    """A local HF Whisper checkpoint directory (``model.safetensors`` +
    ``config.json``, the ``WhisperForConditionalGeneration`` names) as the
    JAX-layout tree :func:`build_model` takes, with its config
    (``stt_tpu/models/whisper.py::load_hf_safetensors``): linear weights
    (out, in) transposed to (in, out), conv kernels (out, in, k) to
    (k, in, out), per-layer leaves stacked. Leaves are float32 numpy (F16
    and BF16 widen exactly). Read by the port's own reader
    (:mod:`stt_tpu_torch.utils.safetensors_io`)."""
    from ..utils.safetensors_io import read_safetensors

    if config is None:
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        config = WhisperConfig(
            name=os.path.basename(path.rstrip("/")),
            n_mels=hf["num_mel_bins"],
            n_audio_state=hf["d_model"],
            n_audio_head=hf["encoder_attention_heads"],
            n_audio_layer=hf["encoder_layers"],
            n_vocab=hf["vocab_size"],
            n_text_state=hf["d_model"],
            n_text_head=hf["decoder_attention_heads"],
            n_text_layer=hf["decoder_layers"],
            n_audio_ctx=hf.get("max_source_positions", 1500),
            n_text_ctx=hf.get("max_target_positions", 448),
        )
    tensors = {key.replace("model.", "", 1): value.float().numpy()
               for key, value in read_safetensors(os.path.join(path, "model.safetensors")).items()}

    def lin(name, bias=True):  # (out, in) -> (in, out)
        out = {"w": np.ascontiguousarray(tensors[f"{name}.weight"].T)}
        if bias:
            out["b"] = tensors[f"{name}.bias"]
        return out

    def attn(prefix):
        return {"q": lin(f"{prefix}.q_proj"), "k": lin(f"{prefix}.k_proj", bias=False),
                "v": lin(f"{prefix}.v_proj"), "o": lin(f"{prefix}.out_proj")}

    def ln(prefix):
        return {"g": tensors[f"{prefix}.weight"], "b": tensors[f"{prefix}.bias"]}

    def block(prefix, cross):
        out = {"ln1": ln(f"{prefix}.self_attn_layer_norm"), "attn": attn(f"{prefix}.self_attn"),
               "ln2": ln(f"{prefix}.final_layer_norm"),
               "mlp": {"fc1": lin(f"{prefix}.fc1"), "fc2": lin(f"{prefix}.fc2")}}
        if cross:
            out["ln_x"] = ln(f"{prefix}.encoder_attn_layer_norm")
            out["xattn"] = attn(f"{prefix}.encoder_attn")
        return out

    def conv(name):  # (out, in, k) -> (k, in, out)
        return {"w": np.ascontiguousarray(tensors[f"{name}.weight"].transpose(2, 1, 0)),
                "b": tensors[f"{name}.bias"]}

    enc = {
        "conv1": conv("encoder.conv1"),
        "conv2": conv("encoder.conv2"),
        "pos": tensors["encoder.embed_positions.weight"],
        "blocks": _stack_blocks([block(f"encoder.layers.{i}", False)
                                 for i in range(config.n_audio_layer)]),
        "ln_post": ln("encoder.layer_norm"),
    }
    dec = {
        "tok": tensors["decoder.embed_tokens.weight"],
        "pos": tensors["decoder.embed_positions.weight"],
        "blocks": _stack_blocks([block(f"decoder.layers.{i}", True)
                                 for i in range(config.n_text_layer)]),
        "ln": ln("decoder.layer_norm"),
    }
    return {"encoder": enc, "decoder": dec}, config


# ---------------------------------------------------------------------------
# Modules (parameter names mirror the JAX tree)
# ---------------------------------------------------------------------------


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Linear(nn.Module):
    """A linear layer, weight (d_in, d_out) in the compute type; or, once
    :func:`quantize_decoder_weights` has run, int8 codes ``wq`` (d_out, d_in)
    with float32 per-out-channel scales ``ws`` (d_out,) and ``native`` set
    for int8 x int8 products. ``shard``, once the layer is split over a
    mesh's model axis (``stt_tpu_torch/parallel/collectives.py``), computes
    the layer from its shards: ``shard(x, layer)``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True) -> None:
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out) if bias else None
        self.register_buffer("wq", None)
        self.register_buffer("ws", None)
        self.native = False
        self.shard = None

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
        # the (d, 3d) projection that replaces q, k and v under the fused
        # policy (fuse_decoder_qkv)
        self.qkv: Optional[Linear] = None


class MLP(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.fc1 = Linear(d, 4 * d)
        self.fc2 = Linear(4 * d, d)
        # set when fc1 and fc2 are split over a mesh's model axis: fc1 by
        # columns, GELU, fc2 by rows, one reduce (``shard(x, mlp)``)
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            return self.shard(x, self)
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
                 policy: AttentionPolicy = AttentionPolicy(),
                 decoder_policy: DecoderPolicy = DecoderPolicy()) -> None:
        super().__init__()
        d = config.n_text_state
        self.n_head = config.n_text_head
        self.n_vocab = config.n_vocab
        self.d_model = d
        self.policy = policy
        self.decoder_policy = decoder_policy
        self.tok = _param(config.n_vocab, d)
        # int8 token table (V_pad, d) and its per-column float32 scales (d,)
        # under the int8 policies; V_pad is V rounded up to 8 for the native
        # product, the padding rows zero
        self.register_buffer("tok_q", None)
        self.register_buffer("tok_s", None)
        self.pos = _param(config.n_text_ctx, d)
        self.blocks = nn.ModuleList(
            Block(d, cross=True) for _ in range(config.n_text_layer)
        )
        self.ln = LayerNorm(d)


class Whisper(nn.Module):
    def __init__(self, config: WhisperConfig,
                 policy: AttentionPolicy = AttentionPolicy(),
                 decoder_policy: DecoderPolicy = DecoderPolicy()) -> None:
        super().__init__()
        self.config = config
        self.encoder = AudioEncoder(config, policy)
        self.decoder = TextDecoder(config, policy, decoder_policy)


def build_model(
    config: WhisperConfig,
    params: Dict[str, Any],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    policy: AttentionPolicy = AttentionPolicy(),
    decoder_policy: DecoderPolicy = DecoderPolicy(),
) -> Whisper:
    """Whisper module on ``device`` in ``dtype`` from a JAX-layout tree
    (e.g. :func:`init_params`) under the attention ``policy`` and the
    ``decoder_policy``, whose weight transforms run on the converted weights
    on ``device``, fused before quantised, as the JAX engine orders them
    (``stt_tpu/engine/engine.py:1064-1079``); no float32 copy is made on the
    host. The quantised weights apply under bfloat16 compute only."""
    with torch.device("meta"):
        model = Whisper(config, policy, decoder_policy)
    model.load_state_dict(from_jax_params(params), strict=True, assign=True)
    model = model.to(device=device, dtype=dtype)
    model.requires_grad_(False)
    if decoder_policy.fused_qkv:
        fuse_decoder_qkv(model.decoder)
    if decoder_policy.int8 and dtype == torch.bfloat16:
        quantize_decoder_weights(model.decoder, native=decoder_policy.native)
    return model.eval()


def _quant_linear_leaf(w: torch.Tensor, dim: int):
    """Symmetric int8 codes and float32 scales over ``dim`` of ``w``
    (``stt_tpu/models/whisper.py:_quant_linear_leaf``): s = max |w| / 127
    (at least 1e-12), q = round(w / s), both in float32 from the stored
    weight; |w - q s| <= s / 2."""
    wf = w.float()
    s = torch.clamp_min(torch.amax(torch.abs(wf), dim=dim, keepdim=True) / 127.0, 1e-12)
    return torch.round(wf / s).to(torch.int8), s.squeeze(dim)


@torch.no_grad()
def quantize_decoder_weights(dec: "TextDecoder", native: bool = False) -> None:
    """The decoder's linear weights and token table as int8, in place
    (``stt_tpu/models/whisper.py:quantize_decoder_weights``): every linear
    of self-attention (fused or not), cross-attention and the MLP per
    out-channel, the token table (V, d) per column, so one scale vector
    serves the embedding gather and the logits; biases, layer norms and the
    position table keep the compute type. ``native`` marks the int8 x int8
    products."""
    for block in dec.blocks:
        for lin in [*(m for m in (block.attn, block.xattn) for m in
                      (m.qkv, m.q, m.k, m.v, m.o) if m is not None),
                    block.mlp.fc1, block.mlp.fc2]:
            q, s = _quant_linear_leaf(lin.w, 0)          # (d_in, d_out) per column
            lin.wq = q.t().contiguous()                  # (d_out, d_in)
            lin.ws = s
            lin.native = native
            lin.w = None
    q, s = _quant_linear_leaf(dec.tok, 0)                # (V, d), scales (d,)
    pad = (-q.shape[0]) % 8 if native else 0
    dec.tok_q = F.pad(q, (0, 0, 0, pad)) if pad else q.contiguous()
    dec.tok_s = s
    dec.tok = None


@torch.no_grad()
def fuse_decoder_qkv(dec: "TextDecoder") -> None:
    """Each decoder layer's self-attention q/k/v projections as one
    (d, 3d) linear, in place (``stt_tpu/models/whisper.py:
    fuse_decoder_qkv``): the weights concatenated on the output axis, the
    bias [q_b, 0, v_b]. Exact: every output column is the same product."""
    for block in dec.blocks:
        attn = block.attn
        if attn.qkv is not None:
            continue
        w = torch.cat([attn.q.w, attn.k.w, attn.v.w], dim=-1)
        b = torch.cat([attn.q.b, torch.zeros_like(attn.q.b), attn.v.b])
        with torch.device("meta"):
            fused = Linear(*w.shape)
        fused.w = nn.Parameter(w, requires_grad=False)
        fused.b = nn.Parameter(b, requires_grad=False)
        attn.qkv = fused
        attn.q = attn.k = attn.v = None


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: LayerNorm) -> torch.Tensor:
    return F.layer_norm(
        x.float(), (x.shape[-1],), p.g.float(), p.b.float(), 1e-5
    ).to(x.dtype)


def _linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """x @ w + b with float32 accumulation, rounded once to x's type. Under
    int8 storage (``stt_tpu/models/whisper.py:266-293``) the codes widen to
    x's type in the product and the per-out-channel scale applies to the
    float32 accumulator; the native route multiplies int8 codes of x (one
    scale a row) by the weight's codes with int32 accumulation, then both
    scales. A layer split over a mesh's model axis computes from its shards
    (``p.shard``)."""
    if p.shard is not None:
        return p.shard(x, p)
    if p.wq is None:
        if p.b is None:
            return torch.matmul(x, p.w)
        y = torch.addmm(p.b, x.reshape(-1, x.shape[-1]), p.w)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    if p.native:
        xq, sx = _quant_activation_rows(x2)
        y = _int8_mm(xq, p.wq).to(torch.float32) * sx
    else:
        y = _mm_f32(x2, p.wq.t().to(x.dtype))
    y = y * p.ws
    if p.b is not None:
        y = y + p.b.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])


def _quant_activation_rows(x: torch.Tensor):
    """Dynamic symmetric int8 codes of x (M, K), one float32 scale a row
    (``stt_tpu/models/whisper.py:_quant_activation_rows``): (xq (M, K) int8,
    sx (M, 1) float32)."""
    xf = x.float()
    sx = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0, 1e-12)
    return torch.round(xf / sx).to(torch.int8), sx


# torch._int_mm on the card takes more than 16 rows and K, N multiples of
# 8; rows are padded to a multiple of 8, at least this many
_INT_MM_MIN_ROWS = 24


def _int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 @ wq (N, K) int8 transposed -> (M, N) int32, exact.
    On the card cuBLASLt's int8 product (``torch._int_mm``, the weight
    column-major as it wants it), the rows zero-padded to a multiple of 8
    above its minimum; on
    the CPU the same integers multiplied as int32."""
    if xq.device.type == "cpu":
        return torch.mm(xq.to(torch.int32), wq.t().to(torch.int32))
    m = xq.shape[0]
    rows = max(_INT_MM_MIN_ROWS, -(-m // 8) * 8)
    if rows != m:
        xq = F.pad(xq, (0, 0, 0, rows - m))
    return torch._int_mm(xq, wq.t())[:m]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), operands of one type, float32 out (the route
    :func:`_narrow_f32` picks)."""
    if not _narrow_f32(a, b):
        return torch.matmul(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def _attn_qkv_lin(hn: torch.Tensor, p: "Attention"):
    """Self-attention's input projections, fused or separate as the
    decoder policy built them (``stt_tpu/models/whisper.py:_attn_qkv_lin``):
    (q, k, v), unscaled, in the head-merged layout."""
    if p.qkv is not None:
        return tuple(torch.chunk(_linear(hn, p.qkv), 3, dim=-1))
    return p.q(hn), p.k(hn), p.v(hn)


def _tok_embed(dec: "TextDecoder", tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute type; an int8 table widens and
    takes its per-column scale in the compute type
    (``stt_tpu/models/whisper.py:_tok_embed``)."""
    if dec.tok_q is None:
        return dec.tok[tokens]
    dtype = dec.pos.dtype
    return dec.tok_q[tokens].to(dtype) * dec.tok_s.to(dtype)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor's bytes (uint8, same shape), for the copies and
    gathers that have no float8 kernel; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape  # (B, T, d) -> (B, H, T, Dh)
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape  # (B, H, T, Dh) -> (B, T, d)
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _narrow_f32(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> bool:
    """True when a product of ``a`` (and ``b``) takes the card route: narrow
    operands in, float32 out (the ``out_dtype`` overloads, the JAX
    package's ``preferred_element_type=float32``). Chosen by the tensor's
    device: the CPU has no kernel for those overloads, so there the
    operands are upcast and multiplied in float32. Products of bf16 values
    are exact in float32, so the two routes differ only in summation
    order. Under float32 compute both routes are the float32 product. A
    product that autograd records (an operand requires grad: training)
    takes the upcast route on the card too, since the overloads have no
    derivative."""
    if a.device.type == "cpu" or a.dtype == torch.float32:
        return False
    return not (torch.is_grad_enabled()
                and (a.requires_grad or (b is not None and b.requires_grad)))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) with float32 accumulation and a
    float32 result; a and b share their leading dims and their type."""
    if not _narrow_f32(a, b):
        return torch.matmul(a.float(), b.float())
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], out.shape[-1])


def _attn_cached(qh, kh, vh, mask=None) -> torch.Tensor:
    """Attention over pre-split, pre-scaled q and K: qh (B, H, Tq, Dh),
    kh/vh (B, H, Tk, Dh), possibly stored narrower (int8 or fp8 cross K/V),
    which are converted to q's type (exactly) and not further. float32
    logits and softmax; the weights round to q's type before the mix.
    Both products take q's type in and give float32 out
    (:func:`_bmm_f32`). Returns float32 (B, H, Tq, Dh)."""
    kh, vh = kh.to(qh.dtype), vh.to(qh.dtype)
    logits = _bmm_f32(qh, kh.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1).to(qh.dtype)
    return _bmm_f32(weights, vh)


def _attention(q, k, v, n_head: int, mask=None, flash: bool = False) -> torch.Tensor:
    """q: (B, Tq, d); k/v: (B, Tk, d). q and k each scaled by
    d_head**-0.25, as whisper. With ``flash`` (the policy's choice at this
    length), unmasked self-attention goes through the flash wrapper: its
    kernel on the card, its plain version on the CPU; under grad its
    autograd Function, whose backward is the two backward kernels."""
    scale = (q.shape[-1] // n_head) ** -0.25
    qh = _split_heads(q, n_head) * scale
    kh = _split_heads(k, n_head) * scale
    vh = _split_heads(v, n_head)
    if flash and mask is None and q.shape[1] == k.shape[1]:
        return _merge_heads(flash_attention(qh.contiguous(), kh.contiguous(),
                                            vh.contiguous()))
    return _merge_heads(_attn_cached(qh, kh, vh, mask).to(q.dtype))


def _self_attn(x, p: Attention, n_head: int, mask=None, flash: bool = False) -> torch.Tensor:
    return p.o(_attention(*_attn_qkv_lin(x, p), n_head, mask, flash))


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
    d = dec.d_model
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


def _reads_int8_codes(qh: torch.Tensor, kh: torch.Tensor) -> bool:
    """Whether a cross-attention over the stored K/V takes the products
    that read the int8 codes (:func:`_attn_int8_codes`): int8 storage, one
    query position, with nothing for autograd to record. Their wrappers
    launch the kernels for CUDA tensors and take the plain versions, which
    are :func:`_attn_cached`'s products, for CPU ones."""
    return (kh.dtype == torch.int8 and qh.shape[2] == 1
            and not (torch.is_grad_enabled() and qh.requires_grad))


def decode_sources(policy: AttentionPolicy, compute_dtype: torch.dtype) -> Tuple[str, ...]:
    """The CUDA sources (``ops/cuda/<name>.cu``) whose kernels a decode step
    under ``policy`` launches on the card: the cross-attention decode
    kernel where it is on, else the int8-code products over int8 storage."""
    if policy.xattn_on:
        return ("xattn_decode",)
    if policy.cross_store_dtype(compute_dtype) == torch.int8:
        return ("cross_mm",)
    return ()


def _attn_int8_codes(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """:func:`_attn_cached` at Tq == 1 over int8 K/V codes, with no widened
    copy of them: both products read the codes (``ops/kernels/cross_mm.py``;
    the weights round to bf16 as they load), the softmax between them is
    the same float32 one. Returns float32 (B, H, 1, Dh)."""
    logits = cross_logits(qh[:, :, 0, :].contiguous(), kh)
    return cross_mix(torch.softmax(logits, dim=-1), vh)[:, :, None, :]


def _cross_layer_attn(qx: torch.Tensor, ckv: CrossKV, li: int,
                      kernel: bool = False) -> torch.Tensor:
    """Cross-attention for one layer against the stored K/V. int8 storage
    folds the per-(row, head) scales into q and the output — logits =
    (q*ks)·kq and out = (w·vq)*vs are exact since each scale is one
    number per (row, head) — so the large K/V are only converted. With
    ``kernel`` a single-position query (Tq == 1) goes through the
    cross-attention decode wrapper for every storage: its kernel on the
    card, its plain version on the CPU. Without it, a single-position
    query over int8 storage reads the codes in both products
    (:func:`_reads_int8_codes`); every other case widens them in
    :func:`_attn_cached`."""
    ck, cv = ckv.k[li], ckv.v[li]
    if ckv.k_scale is not None:
        qx = qx * ckv.k_scale[li].to(qx.dtype)
    if kernel and qx.shape[2] == 1:
        out = xattn_decode(qx[:, :, 0, :].contiguous(), ck, cv)[:, :, None, :]
    elif _reads_int8_codes(qx, ck):
        out = _attn_int8_codes(qx, ck, cv)
    else:
        out = _attn_cached(qx, ck, cv)
    return out if ckv.v_scale is None else out * ckv.v_scale[li]


def _tok_logits(dec: TextDecoder, x: torch.Tensor) -> torch.Tensor:
    """float32 vocab logits against the tied token table as stored: x in
    the compute type, float32 out (the route as :func:`_narrow_f32` says),
    so no float32 copy of the table is made on the card. An int8 table's
    per-column scale folds into x (``stt_tpu/models/whisper.py:677-697``);
    then its codes widen in the product, or on the native route meet x's
    own int8 codes."""
    if dec.tok_q is None:
        if not _narrow_f32(x, dec.tok):
            return F.linear(x.float(), dec.tok.float())
        y = torch.mm(x.reshape(-1, x.shape[-1]), dec.tok.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    x2 = (x * dec.tok_s.to(x.dtype)).reshape(-1, x.shape[-1])
    if dec.decoder_policy.native:
        xq, sx = _quant_activation_rows(x2)
        y = _int8_mm(xq, dec.tok_q)[:, :dec.n_vocab].to(torch.float32) * sx
    else:
        y = _mm_f32(x2, dec.tok_q.t().to(x.dtype))
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _write_slot(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                gate: Optional[torch.Tensor]) -> None:
    """Writes ``new`` (B, H, 1, Dh) into one layer's cache ``buf`` (B, H,
    T_max, Dh) in place at ``pos`` (a float8 cache through its bytes): one
    slot for a 0-d ``pos``
    (``index_copy_`` on the time axis), row b's slot ``pos[b]`` for a (B,)
    one (``index_copy_`` on ``buf`` viewed as (B*H*T_max, Dh), one index per
    row and head, no host read). Where ``gate`` is false the slot keeps
    what it held."""
    buf, new = _raw(buf), _raw(new)
    if pos.dim() == 0:
        slot = pos.reshape(1)
        if gate is not None:
            new = torch.where(gate, new, buf.index_select(2, slot))
        buf.index_copy_(2, slot, new)
        return
    b, h, t_max, d_head = buf.shape
    slots = (torch.arange(b * h, device=pos.device).view(b, h) * t_max
             + pos[:, None]).reshape(-1)
    flat = buf.view(-1, d_head)
    new = new.reshape(-1, d_head)
    if gate is not None:
        new = torch.where(gate.repeat_interleave(h)[:, None], new, flat.index_select(0, slots))
    flat.index_copy_(0, slots, new)


def _decoder_step(dec: TextDecoder, tokens: torch.Tensor, pos: Union[int, torch.Tensor],
                  cache: KVCache, cross_kv: CrossKV,
                  gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode position for the whole batch: tokens (B,) -> logits (B, V)
    float32, at scalar position ``pos`` (a 0-d int64 tensor on the tokens'
    device; a Python int is filled in there, with no host-to-device copy)
    or, as the JAX package's step also takes, at a (B,) vector of per-row
    positions (the drafted resume, each row at its own acceptance
    boundary). Writes k/v of ``pos`` into the cache in place
    (:func:`_write_slot`) and attends over all T_max slots under the mask
    ``slot <= pos`` (per row for a vector). Every shape is the same at
    every position and nothing is read back to the host, so the step can
    be captured in a CUDA graph. With ``gate`` (a bool tensor of ``pos``'s
    shape) false, the slot keeps what it held: the step runs and writes
    nothing there (the beam loop's steps past its stop; the drafted
    resume's finished rows)."""
    n_head = dec.n_head
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.long, device=tokens.device)
    slots = torch.arange(cache.k.shape[3], device=tokens.device)
    # a position past the text context (a long prompt with a long decode)
    # reads the table's last row, as the JAX package's dynamic_slice and
    # gather clamp their index; the cache itself has a slot for every position
    emb_pos = pos.clamp(max=dec.pos.shape[0] - 1) if len(slots) > dec.pos.shape[0] else pos
    if pos.dim() == 0:
        emb = dec.pos.index_select(0, emb_pos.reshape(1))
        mask = torch.where(slots <= pos, 0.0, -torch.inf)
    else:
        emb = dec.pos.index_select(0, emb_pos)
        mask = torch.where(slots[None, :] <= pos[:, None], 0.0, -torch.inf)[:, None, None, :]
    x = _tok_embed(dec, tokens)
    h = (x + emb.to(x.dtype))[:, None, :]
    scale = (h.shape[-1] // n_head) ** -0.25
    for li, block in enumerate(dec.blocks):
        hn = block.ln1(h)
        q_lin, k_lin, v_lin = _attn_qkv_lin(hn, block.attn)
        qh = _split_heads(q_lin, n_head) * scale
        k_new = _split_heads(k_lin, n_head) * scale
        v_new = _split_heads(v_lin, n_head)
        _write_slot(cache.k[li], k_new.to(cache.k.dtype), pos, gate)
        _write_slot(cache.v[li], v_new.to(cache.v.dtype), pos, gate)
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
    x = _tok_embed(dec, tokens[:, :width])
    h = x + dec.pos[:width][None].to(x.dtype)
    scale = (h.shape[-1] // n_head) ** -0.25
    causal = _causal_mask(width, h.device)
    for li, block in enumerate(dec.blocks):
        hn = block.ln1(h)
        q_lin, k_lin, v_lin = _attn_qkv_lin(hn, block.attn)
        qh = _split_heads(q_lin, n_head) * scale
        k_new = (_split_heads(k_lin, n_head) * scale).to(cache.k.dtype)
        v_new = _split_heads(v_lin, n_head).to(cache.v.dtype)
        _raw(cache.k)[li, :, :, :width] = _raw(k_new)
        _raw(cache.v)[li, :, :, :width] = _raw(v_new)
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
    sot position (openai ``DecodingTask._main_loop``). Under the ``seq``
    prefill policy one :func:`_decoder_step` a position
    (``stt_tpu/models/whisper.py:979-993``), else one teacher-forced
    pass."""
    if p_len <= 1:
        return torch.zeros(tokens.shape[0], device=tokens.device)
    if dec.decoder_policy.prefill == "seq":
        no_speech = None
        for i in range(p_len - 1):
            logits = _decoder_step(dec, tokens[:, i], i, cache, cross_kv)
            if i == sot_pos:
                no_speech = torch.softmax(logits, dim=-1)[:, layout.no_speech]
        if no_speech is None:
            no_speech = torch.zeros(tokens.shape[0], device=tokens.device)
        return no_speech
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
    x = _tok_embed(dec, tokens)
    h = x + dec.pos[:t][None].to(x.dtype)
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


def cross_attention_weights(model: Whisper, tokens: torch.Tensor, enc_out: torch.Tensor,
                            n_align_layers: int = 2) -> torch.Tensor:
    """Teacher-forced decoder pass returning the cross-attention maps of
    the last ``n_align_layers`` decoder layers: (K, B, H, T_text, T_audio)
    float32 softmax weights, the word-timestamp alignment signal
    (``stt_tpu/models/whisper.py::cross_attention_weights``). The cross K/V
    are stored as the decoder's policy says, then dequantised
    (:func:`_cross_dequant`); every product takes the compute type in and
    gives float32 (:func:`_bmm_f32`). Each map is written into the output
    as its layer runs, so no more than one layer's logits are alive at
    once, and the last layer stops once its map is in."""
    dec = model.decoder
    n_head = dec.n_head
    b, t = tokens.shape
    x = _tok_embed(dec, tokens)
    h = x + dec.pos[:t][None].to(x.dtype)
    causal = _causal_mask(t, h.device)
    xk, xv = _cross_dequant(precompute_cross_kv(dec, enc_out))
    n_layers = len(dec.blocks)
    k_layers = max(1, min(n_align_layers, n_layers))
    split = n_layers - k_layers
    scale = (h.shape[-1] // n_head) ** -0.25
    out = torch.empty((k_layers, b, n_head, t, xk.shape[3]), dtype=torch.float32,
                      device=h.device)
    for li, block in enumerate(dec.blocks):
        h = h + _self_attn(block.ln1(h), block.attn, n_head, causal)
        qx = _split_heads(block.xattn.q(block.ln_x(h)), n_head) * scale
        ck, cv = xk[li].to(h.dtype), xv[li].to(h.dtype)
        if li < split:
            x_out = _attn_cached(qx, ck, cv)
        else:
            w = out[li - split]
            w.copy_(torch.softmax(_bmm_f32(qx, ck.transpose(-1, -2)), dim=-1))
            if li == n_layers - 1:
                break  # the last map is in; the rest of the layer feeds nothing
            x_out = _bmm_f32(w.to(cv.dtype), cv)
        h = h + block.xattn.o(_merge_heads(x_out.to(h.dtype)))
        h = h + block.mlp(block.ln2(h))
    return out


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


def _ts_base_mask(config: WhisperConfig) -> np.ndarray:
    """Additive suppression in timestamp mode: the specials in [sot,
    ts_begin) stay banned, eot and the timestamp tokens are allowed."""
    layout = token_layout(config.n_vocab)
    mask = np.zeros(config.n_vocab, np.float32)
    mask[layout.sot:layout.timestamp_begin] = -np.inf
    mask[layout.eot] = 0.0
    return mask


def _ts_begin_mask(config: WhisperConfig) -> np.ndarray:
    """The begin mask in timestamp mode: a lone space only (the first token
    is a timestamp anyway)."""
    mask = np.zeros(config.n_vocab, np.float32)
    mask[BLANK_TOKEN] = -np.inf
    return mask


# ---------------------------------------------------------------------------
# Decode routes: repetition penalty, n-gram bans, sampling, timestamps
# ---------------------------------------------------------------------------

MAX_INITIAL_TIMESTAMP = 50  # 1.0 s at 0.02 s a token; the JAX engine passes no other


class Route(NamedTuple):
    """The logit rules a decode applies besides the suppress and begin
    masks, fixed for a graph entry as the JAX package traces a program for
    each: the repetition penalty and the n-gram bans of ``greedy_decode``
    and ``beam_decode``, the categorical draw of ``sample_decode``, the
    timestamp grammar of ``greedy_decode_timestamps`` and ``beam_decode``'s
    ``with_timestamps``. The penalty's value is a per-row tensor of the
    state, so one entry serves every value; ``ngram_n`` is the banned
    n-gram's size (0: none)."""

    timestamps: bool = False
    sampled: bool = False
    penalised: bool = False
    ngram_n: int = 0


GREEDY = Route()


class Rules(NamedTuple):
    """A route's state, allocated once beside the decode state and reset in
    place for each group; ``rows`` is (B,) at beam 1 and (B, K) for beams.
    A field the route does not use is None."""

    p_len: torch.Tensor                    # () int64: the prompt's width
    ngram: Optional[torch.Tensor]          # (n - 1,) int64: 0..n-2, the banned n-gram's tail
    rep_penalty: Optional[torch.Tensor]    # (B,) float32
    seen: Optional[torch.Tensor]           # (*rows, V) bool: text tokens prompted or emitted
    temperature: Optional[torch.Tensor]    # () float32, at least 1e-3
    generator: Optional[torch.Generator]   # the draws of the sampled route
    last_ts: Optional[torch.Tensor]        # (*rows,) int64: ts_begin - 1 before the first
    last_was_ts: Optional[torch.Tensor]    # (*rows,) bool
    penult_was_ts: Optional[torch.Tensor]  # (*rows,) bool
    vocab: Optional[torch.Tensor]          # (V,) int64: the token ids


def init_rules(config: WhisperConfig, rows: tuple, route: Route,
               device: torch.device) -> Rules:
    """Zeroed rules of ``route`` for ``rows`` decode rows."""
    v = config.n_vocab
    ts_begin = token_layout(v).timestamp_begin

    def opt(on, make):
        return make() if on else None

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    pen, ts = route.penalised, route.timestamps
    return Rules(
        p_len=zeros((), torch.long),
        ngram=opt(route.ngram_n > 0, lambda: torch.arange(route.ngram_n - 1, device=device)),
        rep_penalty=opt(pen, lambda: torch.ones(rows[0], device=device)),
        seen=opt(pen, lambda: zeros((*rows, v), torch.bool)),
        temperature=opt(route.sampled, lambda: torch.ones((), device=device)),
        generator=opt(route.sampled, lambda: torch.Generator(device=device)),
        last_ts=opt(ts, lambda: torch.full(rows, ts_begin - 1, device=device)),
        last_was_ts=opt(ts, lambda: zeros(rows, torch.bool)),
        penult_was_ts=opt(ts, lambda: zeros(rows, torch.bool)),
        vocab=opt(ts, lambda: torch.arange(v, device=device)),
    )


def _seen_text_mask(tokens: torch.Tensor, prompt_len: torch.Tensor, eot: int,
                    v: int) -> torch.Tensor:
    """(B, V) bool: the text tokens at each row's logical prompt positions
    (specials excluded), the seen-set's seed
    (``stt_tpu/models/whisper.py:1101``)."""
    b, t = tokens.shape
    in_prompt = torch.arange(t, device=tokens.device)[None, :] < prompt_len[:, None]
    ids = torch.where(in_prompt, tokens, v)
    seen = torch.zeros(b, v + 1, dtype=torch.bool, device=tokens.device).scatter_(1, ids, True)
    seen = seen[:, :v].clone()
    seen[:, eot:] = False
    return seen


def reset_rules(rules: Rules, prompt_rows: torch.Tensor, prompt_len: torch.Tensor,
                p_len: int, *, rep_penalty: Optional[torch.Tensor] = None,
                temperature: float = 1.0, seed: int = 0) -> None:
    """Reset ``rules`` for a group: ``prompt_rows`` (B, T) are the rows'
    tokens (beam 0's for beams, whose beams share the seed seen-set),
    ``rep_penalty`` (B,) each row's penalty, ``temperature`` the draw's
    (at least 1e-3, ``:1509``) and ``seed`` the generator's."""
    rules.p_len.fill_(p_len)
    if rules.seen is not None:
        if rep_penalty is None:
            raise ValueError("a penalised route needs rep_penalty")
        rules.rep_penalty.copy_(rep_penalty)
        seen = _seen_text_mask(prompt_rows, prompt_len, token_layout(rules.seen.shape[-1]).eot,
                               rules.seen.shape[-1])
        rules.seen.copy_(seen.view(seen.shape[0], *[1] * (rules.seen.dim() - 2), -1)
                         .expand_as(rules.seen))
    if rules.temperature is not None:
        rules.temperature.fill_(max(float(np.float32(temperature)), float(np.float32(1e-3))))
        rules.generator.manual_seed(int(seed))
    if rules.last_ts is not None:
        rules.last_ts.fill_(token_layout(rules.vocab.shape[0]).timestamp_begin - 1)
        rules.last_was_ts.zero_()
        rules.penult_was_ts.zero_()


def _ngram_banned_tokens(tokens: torch.Tensor, pos: torch.Tensor, tail_at: torch.Tensor,
                         v: int) -> torch.Tensor:
    """(R, V) bool: the tokens that would complete an n-gram already in each
    row of ``tokens`` (R, T), whose sequence fills [0, ``pos``)
    (``stt_tpu/models/whisper.py:1081``), ``tail_at`` = 0..n-2: the
    (n-1)-token tail ending at ``pos - 1`` is matched at every window
    start, and a window whose next token lies before ``pos`` bans that
    token."""
    r, t = tokens.shape
    n = len(tail_at) + 1
    start = (pos - (n - 1)).clamp(0, t - (n - 1))  # lax.dynamic_slice's clamp
    tail = tokens.index_select(1, start + tail_at)
    match = torch.ones(r, t, dtype=torch.bool, device=tokens.device)
    for j in range(n - 1):
        match = match & torch.roll(tokens == tail[:, j:j + 1], -j, dims=1)
    valid = match & (torch.arange(t, device=tokens.device) + n - 1 < pos)
    nxt = torch.roll(tokens, -(n - 1), dims=1)
    hits = torch.zeros(r, v, dtype=torch.int32, device=tokens.device)
    return hits.scatter_add_(1, nxt, valid.to(torch.int32)) > 0


def _penalise(rules: Rules, logits: torch.Tensor, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """The repetition penalty (a seen token's logit divided by the row's
    penalty when positive, multiplied when negative, CTranslate2's rule),
    then the n-gram bans, on logits (*rows, V), before the suppress and
    begin masks (``stt_tpu/models/whisper.py:1216-1223``); ``tokens``
    (R, T) holds every decode row's sequence."""
    if rules.seen is not None:
        rp = rules.rep_penalty.view(-1, *[1] * (logits.dim() - 1))
        logits = torch.where(rules.seen, torch.where(logits > 0, logits / rp, logits * rp),
                             logits)
    if rules.ngram is not None:
        banned = _ngram_banned_tokens(tokens, pos, rules.ngram, logits.shape[-1])
        logits = torch.where(banned.view(logits.shape), -torch.inf, logits)
    return logits


def _ts_apply(rules: Rules, logits: torch.Tensor, gen_count: torch.Tensor) -> torch.Tensor:
    """openai-whisper's timestamp rules on logits (*rows, V)
    (``stt_tpu/models/whisper.py:_ts_apply``), ``gen_count`` the tokens
    generated so far: after a lone timestamp only its pair or eot, after a
    pair text only; timestamps never decrease and after a closed pair the
    next opens strictly later; the first token is a timestamp within
    ``MAX_INITIAL_TIMESTAMP``; and a timestamp is forced when their summed
    probability beats the best text token's. With fewer than two generated
    tokens the penultimate counts as a timestamp, so a lone initial one is
    followed by text."""
    layout = token_layout(logits.shape[-1])
    ts_begin, vocab = layout.timestamp_begin, rules.vocab
    is_ts, is_text = vocab >= ts_begin, vocab < layout.eot
    penult = rules.penult_was_ts | (gen_count < 2)
    ban_ts = rules.last_was_ts & penult
    force_ts = rules.last_was_ts & ~penult
    mask = torch.zeros_like(logits)
    mask = torch.where(ban_ts[..., None] & is_ts, -torch.inf, mask)
    mask = torch.where(force_ts[..., None] & is_text, -torch.inf, mask)
    floor = rules.last_ts + torch.where(force_ts, 0, 1)
    mask = torch.where(is_ts & (vocab < floor[..., None]), -torch.inf, mask)
    init_allowed = is_ts & (vocab <= ts_begin + MAX_INITIAL_TIMESTAMP)
    mask = torch.where((gen_count == 0) & ~init_allowed, -torch.inf, mask)
    logits = logits + mask
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts, logprobs, -torch.inf), dim=-1)
    max_text = torch.amax(torch.where(is_ts, -torch.inf, logprobs), dim=-1)
    force_sum = ts_logprob > max_text
    return torch.where(force_sum[..., None] & ~is_ts, -torch.inf, logits)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws in float32 on the generator's device,
    ``-log(-log(u))`` for u uniform in [tiny, 1), the transform
    ``jax.random.gumbel`` applies to its own bits (the bit streams differ:
    threefry there, Philox here). The sampled route draws through this
    function alone, so a test can feed in the JAX package's draws."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _choose(rules: Rules, logits: torch.Tensor) -> torch.Tensor:
    """The next token: the argmax, or on the sampled route the categorical
    draw at the route's temperature, ``argmax(gumbel + logits / T)`` as
    ``jax.random.categorical`` computes it."""
    if rules.temperature is None:
        return torch.argmax(logits, dim=-1)
    noise = gumbel_noise(logits.shape, rules.generator)
    return torch.argmax(noise + logits / rules.temperature, dim=-1)


def _advance_rules(rules: Rules, next_tok: torch.Tensor, active: torch.Tensor, eot: int,
                   parent: Optional[torch.Tensor] = None,
                   run: Optional[torch.Tensor] = None) -> None:
    """After ``next_tok`` (*rows) is appended: a text token joins its row's
    seen-set, and the timestamp state advances where ``active``
    (``stt_tpu/models/whisper.py:_ts_state_update``). For beams the state
    first follows ``parent`` (B, K), and where ``run`` (0-d) is false all
    of it keeps what it held."""
    def take(x):
        return x if parent is None else _gather_beams(x, parent)

    def commit(buf, new):
        buf.copy_(new if run is None else torch.where(run, new, buf))

    if rules.seen is not None:
        seen, idx = take(rules.seen), next_tok[..., None]
        commit(rules.seen, seen.scatter(-1, idx, seen.gather(-1, idx)
                                        | (next_tok < eot)[..., None]))
    if rules.last_ts is not None:
        ts_begin = token_layout(rules.vocab.shape[0]).timestamp_begin
        last_ts, last_was, penult = (take(rules.last_ts), take(rules.last_was_ts),
                                     take(rules.penult_was_ts))
        is_ts = active & (next_tok >= ts_begin)
        commit(rules.last_ts, torch.where(is_ts, next_tok, last_ts))
        commit(rules.penult_was_ts, torch.where(active, last_was & is_ts, penult))
        commit(rules.last_was_ts, torch.where(active, is_ts, last_was))


def _route_masks(config: WhisperConfig, route: Route) -> tuple:
    """(suppress, begin-if-suppress-blank) masks of ``route``: the
    timestamp grammar's base mask and a blank-only begin mask, else
    :func:`_suppress_mask` and :func:`_sample_begin_mask`."""
    if route.timestamps:
        return _ts_base_mask(config), _ts_begin_mask(config)
    return _suppress_mask(config), _sample_begin_mask(config)


class DecodeState(NamedTuple):
    """Everything the greedy loop reads and writes, allocated once for a
    (rows, prompt length, max_new, route) shape and updated in place, so a
    CUDA graph of :func:`_decode_chunk` can be replayed against it. The
    masks are built once from numpy."""

    tokens: torch.Tensor       # (B, T_max) int64: prompt + generated, eot-padded
    cache: KVCache             # self-attention K/V, (L, B, H, T_max, Dh)
    pos: torch.Tensor          # () int64: the position the next step writes
    finished: torch.Tensor     # (B,) bool
    sum_lp: torch.Tensor       # (B,) float32: generated-token logprob sums
    prompt_len: torch.Tensor   # (B,) int64: each row's logical prompt length
    suppress: torch.Tensor     # (V,) float32: the route's suppress mask
    begin_blank: torch.Tensor  # (V,) float32: the route's begin mask
    begin: torch.Tensor        # (V,) float32: ``begin_blank`` or zeros, per call
    rules: Rules               # the route's state


def init_decode_state(config: WhisperConfig, batch: int, p_len: int, max_new: int,
                      dtype: torch.dtype, device: torch.device, *, route: Route = GREEDY,
                      cache: Optional[KVCache] = None) -> DecodeState:
    """Zeroed decode state for ``batch`` rows of a ``p_len``-token prompt
    and up to ``max_new`` generated tokens on ``route``; the self cache in
    ``dtype``, or ``cache`` (of that shape) when given."""
    t_max = p_len + max_new
    suppress, begin_blank = _route_masks(config, route)
    return DecodeState(
        tokens=torch.zeros((batch, t_max), dtype=torch.long, device=device),
        cache=init_kv_cache(config, batch, t_max, dtype, device) if cache is None else cache,
        pos=torch.zeros((), dtype=torch.long, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        sum_lp=torch.zeros(batch, dtype=torch.float32, device=device),
        prompt_len=torch.zeros(batch, dtype=torch.long, device=device),
        suppress=torch.from_numpy(suppress).to(device),
        begin_blank=torch.from_numpy(begin_blank).to(device),
        begin=torch.zeros(config.n_vocab, dtype=torch.float32, device=device),
        rules=init_rules(config, (batch,), route, device),
    )


def start_decode(dec: TextDecoder, state: DecodeState, prompt: torch.Tensor,
                 prompt_len: torch.Tensor, cross_kv: CrossKV, *,
                 suppress_blank: bool = True, sot_pos: int = 0,
                 rep_penalty: Optional[torch.Tensor] = None, temperature: float = 1.0,
                 seed: int = 0) -> torch.Tensor:
    """Reset ``state`` for a new group: the prompt (B, P) right-padded with
    eot, eot past it, position P, no row finished, the route's rules
    (:func:`reset_rules`); then the prefill fills cache positions [0, P -
    1). Returns p(no_speech) at ``sot_pos``."""
    layout = token_layout(dec.n_vocab)
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
    reset_rules(state.rules, state.tokens, prompt_len, p_len, rep_penalty=rep_penalty,
                temperature=temperature, seed=seed)
    return _prefill(dec, state.tokens, p_len, state.cache, cross_kv, sot_pos, layout)


def _decode_chunk(dec: TextDecoder, state: DecodeState, cross_kv: CrossKV,
                  n_steps: int = FINISH_CHECK_EVERY) -> None:
    """``n_steps`` steps on ``state`` in place, reading and writing only its
    buffers and ``cross_kv`` (no host read, no allocation that outlives the
    call): the body of the JAX package's ``greedy_decode`` while-loop (its
    penalty and bans on a penalised route), of ``sample_decode`` on a
    sampled one and of ``greedy_decode_timestamps`` on a timestamp one,
    ``n_steps`` times. The caller keeps ``pos + n_steps`` within the
    state's T_max."""
    eot = token_layout(dec.n_vocab).eot
    pos, rules = state.pos, state.rules
    for _ in range(n_steps):
        last = state.tokens.index_select(1, pos.reshape(1) - 1)[:, 0]
        logits = _decoder_step(dec, last, pos - 1, state.cache, cross_kv)
        logits = _penalise(rules, logits, state.tokens, pos)
        logits = logits + state.suppress + torch.where(
            (state.prompt_len == pos)[:, None], state.begin, 0.0
        )
        if rules.last_ts is not None:
            logits = _ts_apply(rules, logits, pos - rules.p_len)
        logprobs = torch.log_softmax(logits, dim=-1)
        next_tok = torch.where(state.finished, eot, _choose(rules, logits))
        tok_lp = torch.gather(logprobs, 1, next_tok[:, None])[:, 0]
        state.sum_lp.add_(torch.where(state.finished, 0.0, tok_lp))
        state.tokens.index_copy_(1, pos.reshape(1), next_tok[:, None])
        _advance_rules(rules, next_tok, ~state.finished, eot)
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


def _route_decode(model: Whisper, enc_out: torch.Tensor, prompt: torch.Tensor,
                  prompt_len: torch.Tensor, max_new_tokens: int, route: Route, *,
                  suppress_blank: bool, sot_pos: int, cross_kv: Optional[CrossKV],
                  rep_penalty: Optional[torch.Tensor] = None, temperature: float = 1.0,
                  seed: int = 0) -> DecodeResult:
    """The uncaptured decode at beam 1 on ``route``: chunks of
    ``FINISH_CHECK_EVERY`` steps (the last one shorter when
    ``max_new_tokens`` is not a multiple) until a chunk leaves every row
    finished."""
    dec = model.decoder
    device = enc_out.device
    b, p_len = prompt.shape
    state = init_decode_state(model.config, b, p_len, max_new_tokens,
                              dec.decoder_policy.cache_dtype(enc_out.dtype), device, route=route)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(dec, enc_out)
    no_speech_prob = start_decode(
        dec, state, prompt.to(device=device, dtype=torch.long), prompt_len.to(device),
        cross_kv, suppress_blank=suppress_blank, sot_pos=sot_pos,
        rep_penalty=None if rep_penalty is None else rep_penalty.to(device),
        temperature=temperature, seed=seed,
    )
    for done in range(0, max_new_tokens, FINISH_CHECK_EVERY):
        _decode_chunk(dec, state, cross_kv, min(FINISH_CHECK_EVERY, max_new_tokens - done))
        if bool(state.finished.all()):
            break
    return finish_decode(state, p_len, no_speech_prob)


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
    rep_penalty: Optional[torch.Tensor] = None,
    ngram_n: int = 0,
) -> DecodeResult:
    """Batched greedy decode with per-row early stop, uncaptured: the JAX
    package's ``greedy_decode``. prompt: (B, P) integer, right-padded with
    eot past ``prompt_len``; enc_out: (B, T_a, d). ``rep_penalty`` (B,),
    when given, takes the penalised route (as an array there does);
    ``ngram_n`` bans repeated n-grams of that size."""
    route = Route(penalised=rep_penalty is not None, ngram_n=int(ngram_n))
    return _route_decode(model, enc_out, prompt, prompt_len, max_new_tokens, route,
                         suppress_blank=suppress_blank, sot_pos=sot_pos, cross_kv=cross_kv,
                         rep_penalty=rep_penalty)


def sample_decode(
    model: Whisper,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 1.0,
    seed: int = 0,
    suppress_blank: bool = True,
    sot_pos: int = 0,
    cross_kv: Optional[CrossKV] = None,
    rep_penalty: Optional[torch.Tensor] = None,
    ngram_n: int = 0,
) -> DecodeResult:
    """Categorical sampling at ``temperature`` (the retry rungs of the
    temperature-fallback ladder), uncaptured: the JAX package's
    ``sample_decode``, each step's draw from :func:`gumbel_noise` on a
    generator seeded with ``seed``."""
    route = Route(sampled=True, penalised=rep_penalty is not None, ngram_n=int(ngram_n))
    return _route_decode(model, enc_out, prompt, prompt_len, max_new_tokens, route,
                         suppress_blank=suppress_blank, sot_pos=sot_pos, cross_kv=cross_kv,
                         rep_penalty=rep_penalty, temperature=temperature, seed=seed)


def greedy_decode_timestamps(
    model: Whisper,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    max_new_tokens: int,
    *,
    sot_pos: int = 0,
    cross_kv: Optional[CrossKV] = None,
) -> DecodeResult:
    """Greedy decode with timestamp tokens under openai-whisper's grammar
    (:func:`_ts_apply`), uncaptured: the JAX package's
    ``greedy_decode_timestamps`` (its begin mask always on, no penalty or
    bans). The prompt omits ``no_timestamps``; the segments come from
    :func:`split_timestamp_segments`."""
    return _route_decode(model, enc_out, prompt, prompt_len, max_new_tokens,
                         Route(timestamps=True), suppress_blank=True, sot_pos=sot_pos,
                         cross_kv=cross_kv)


def split_timestamp_segments(token_ids, config: WhisperConfig, duration: float):
    """Host-side: a timestamp-mode token sequence as ``[(start_sec, end_sec,
    [text token ids]), ...]`` (``stt_tpu/models/whisper.py:1875``). Whisper
    emits ``<|t0|> text <|t1|><|t1|> text <|t2|>``; a trailing open segment
    ends at ``duration``."""
    layout = token_layout(config.n_vocab)
    ts_begin = layout.timestamp_begin
    segments = []
    seg_start: Optional[float] = None
    seg_tokens: list = []
    prev_was_ts = False
    for tok in token_ids:
        tok = int(tok)
        if tok == layout.eot:
            break
        if tok >= ts_begin:
            t_sec = (tok - ts_begin) * 0.02
            if seg_start is None:
                seg_start = t_sec
            elif not prev_was_ts:
                # closing timestamp
                if seg_tokens:
                    segments.append((seg_start, t_sec, seg_tokens))
                seg_start = None
                seg_tokens = []
            else:
                # second of a pair: opens the next segment
                seg_start = t_sec
            prev_was_ts = True
        else:
            if seg_start is None:
                seg_start = 0.0
            seg_tokens.append(tok)
            prev_was_ts = False
    if seg_tokens:
        segments.append((seg_start or 0.0, duration, seg_tokens))
    return segments


def compression_ratio(text: str) -> float:
    """zlib compression ratio: whisper's repetition heuristic."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# ---------------------------------------------------------------------------
# Drafted greedy decoding (streaming partials verify the previous partial)
# ---------------------------------------------------------------------------

# positions of one verify chunk: the float32 logits materialise as
# (B, VERIFY_CHUNK, V), ~106 MB at 64 rows of whisper's vocabulary
VERIFY_CHUNK = 8


class DraftedResult(NamedTuple):
    """:class:`DecodeResult` plus the per-row count of draft tokens the
    verify pass accepted (``stt_tpu/models/whisper.py:1251``)."""

    tokens: torch.Tensor
    lengths: torch.Tensor
    sum_logprob: torch.Tensor
    no_speech_prob: torch.Tensor
    n_accepted: torch.Tensor      # (B,) int64


class DraftState(NamedTuple):
    """Everything the drafted decode reads and writes, allocated once for a
    (rows, prompt length, max_new, draft width D) shape and updated in
    place, so a CUDA graph of :func:`_drafted_chunk` can be replayed
    against it. Unlike :class:`DecodeState` every row has its own position:
    after the verify pass each row resumes at its own acceptance boundary.
    The self cache (and, in the engine, the cross K/V) may be another
    entry's of the same shape (``init_draft_state(cache=)``)."""

    tokens: torch.Tensor       # (B, T_max) int64: prompt + committed tokens, eot-padded
    cache: KVCache             # self-attention K/V, (L, B, H, T_max, Dh)
    pos: torch.Tensor          # (B,) int64: the position each row writes next
    finished: torch.Tensor     # (B,) bool
    sum_lp: torch.Tensor       # (B,) float32: generated-token logprob sums
    prompt_len: torch.Tensor   # (B,) int64: each row's logical prompt length
    draft: torch.Tensor        # (B, D) int64: eot-padded past draft_len
    draft_len: torch.Tensor    # (B,) int64
    n_accepted: torch.Tensor   # (B,) int64: draft tokens the verify pass accepted
    suppress: torch.Tensor     # (V,) float32: :func:`_suppress_mask`
    begin_blank: torch.Tensor  # (V,) float32: :func:`_sample_begin_mask`
    begin: torch.Tensor        # (V,) float32: ``begin_blank`` or zeros, per call


def init_draft_state(config: WhisperConfig, batch: int, p_len: int, max_new: int,
                     d_max: int, dtype: torch.dtype, device: torch.device, *,
                     cache: Optional[KVCache] = None) -> DraftState:
    """Zeroed drafted-decode state for ``batch`` rows of a ``p_len``-token
    prompt, drafts of up to ``d_max`` (<= ``max_new``) tokens and up to
    ``max_new`` generated tokens; the self cache in ``dtype``, or ``cache``
    (of that shape) when given."""
    if not 0 <= d_max <= max_new:
        raise ValueError(f"draft width {d_max} is not within 0..max_new={max_new}")
    t_max = p_len + max_new
    if cache is None:
        cache = init_kv_cache(config, batch, t_max, dtype, device)

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DraftState(
        tokens=zeros(batch, t_max), cache=cache, pos=zeros(batch),
        finished=zeros(batch, dtype=torch.bool),
        sum_lp=zeros(batch, dtype=torch.float32), prompt_len=zeros(batch),
        draft=zeros(batch, d_max), draft_len=zeros(batch), n_accepted=zeros(batch),
        suppress=torch.from_numpy(_suppress_mask(config)).to(device),
        begin_blank=torch.from_numpy(_sample_begin_mask(config)).to(device),
        begin=zeros(config.n_vocab, dtype=torch.float32),
    )


def _verify_positions(dec: TextDecoder, h: torch.Tensor, begin_rows: torch.Tensor,
                      suppress: torch.Tensor, begin: torch.Tensor,
                      chunk: int = VERIFY_CHUNK):
    """Masked greedy argmax and its logprob at every position of ``h``
    (B, J, d): (g (B, J) int64, lp (B, J) float32)
    (``stt_tpu/models/whisper.py:1261-1297``). ``begin_rows`` (B, J) marks
    the positions where the sample-begin mask applies. Chunked over J so
    the float32 logits materialise ``chunk`` positions at a time."""
    gs, lps = [], []
    for j in range(0, h.shape[1], chunk):
        logits = _tok_logits(dec, dec.ln(h[:, j:j + chunk]))
        logits = logits + suppress + torch.where(begin_rows[:, j:j + chunk, None], begin, 0.0)
        g = torch.argmax(logits, dim=-1)
        gs.append(g)
        lps.append(torch.gather(torch.log_softmax(logits, dim=-1), 2, g[..., None])[..., 0])
    return torch.cat(gs, dim=1), torch.cat(lps, dim=1)


def start_drafted(dec: TextDecoder, state: DraftState, prompt: torch.Tensor,
                  prompt_len: torch.Tensor, draft: torch.Tensor, draft_len: torch.Tensor,
                  cross_kv: CrossKV, *, suppress_blank: bool = True,
                  sot_pos: int = 0) -> torch.Tensor:
    """Reset ``state`` for a new group and verify the draft
    (``stt_tpu/models/whisper.py:1348-1420``): one teacher-forced pass over
    prompt (B, P) + draft (B, D) (eot-padded past ``draft_len``) writes the
    self cache of positions [0, P + D); the longest draft prefix equal to
    the masked greedy choice is accepted (cut after an accepted eot), the
    greedy token at the first mismatch is committed for free, and every
    row's position, finished flag and logprob sum are set for the resume.
    Returns p(no_speech) at ``sot_pos``. No host read."""
    layout = token_layout(dec.n_vocab)
    eot = layout.eot
    p_len = prompt.shape[1]
    d_max = state.draft.shape[1]
    t_max = state.tokens.shape[1]
    max_new = t_max - p_len
    dev = prompt.device
    state.draft.copy_(draft)
    state.draft_len.copy_(draft_len)
    state.prompt_len.copy_(prompt_len)
    if suppress_blank:
        state.begin.copy_(state.begin_blank)
    else:
        state.begin.zero_()
    tokens = state.tokens
    tokens.fill_(eot)
    tokens[:, :p_len].copy_(prompt)
    tokens[:, p_len:p_len + d_max].copy_(state.draft)

    # the verify pass over prompt + draft
    h = _prefill_parallel(dec, tokens, p_len + d_max, state.cache, cross_kv)
    ns_logits = _tok_logits(dec, dec.ln(h[:, sot_pos]))
    no_speech_prob = torch.softmax(ns_logits, dim=-1)[:, layout.no_speech]
    # g[:, j] is the token greedy writes at position p_len + j
    jd = torch.arange(d_max + 1, device=dev)
    begin_rows = (p_len + jd[None, :]) == state.prompt_len[:, None]
    g, lp_g = _verify_positions(dec, h[:, p_len - 1:], begin_rows, state.suppress,
                                state.begin)

    # acceptance: the longest prefix where the draft is greedy's choice
    dlen = state.draft_len.clamp(0, d_max)
    eq = (state.draft == g[:, :d_max]) & (jd[None, :d_max] < dlen[:, None])
    accs = torch.cumprod(eq.long(), dim=1)
    acc = accs.sum(dim=1)
    # greedy stops at an eot: keep up to the first accepted eot
    acc_eot = (state.draft == eot) & accs.bool()
    has_eot = acc_eot.any(dim=1)
    n_keep = torch.where(has_eot, torch.argmax(acc_eot.long(), dim=1) + 1, acc)
    commit_c = ~has_eot & (n_keep < max_new)
    c_tok = torch.where(commit_c, torch.gather(g, 1, n_keep[:, None])[:, 0], eot)

    # the committed row: accepted draft prefix, the corrected token, eot
    col = torch.arange(t_max, device=dev)[None, :]
    end_pos = p_len + n_keep
    tokens.copy_(torch.where(col < end_pos[:, None], tokens, eot))
    tokens.copy_(torch.where((col == end_pos[:, None]) & commit_c[:, None],
                             c_tok[:, None], tokens))
    lp_keep = torch.where(jd[None, :] < n_keep[:, None], lp_g, 0.0).sum(dim=1)
    lp_c = torch.gather(lp_g, 1, n_keep[:, None])[:, 0]
    state.sum_lp.copy_(lp_keep + torch.where(commit_c, lp_c, 0.0))
    state.pos.copy_(end_pos + commit_c.long())
    # done: an accepted eot ended the row, the corrected token is the eot,
    # or the committed tokens fill the max_new budget
    state.finished.copy_(has_eot | (c_tok == eot) | (state.pos >= t_max))
    state.n_accepted.copy_(acc)
    return no_speech_prob


def _drafted_chunk(dec: TextDecoder, state: DraftState, cross_kv: CrossKV,
                   n_steps: int = FINISH_CHECK_EVERY) -> None:
    """``n_steps`` steps of the per-row resume on ``state`` in place
    (``stt_tpu/models/whisper.py:1422-1449``), each row at its own
    position, with no host read. Every update of a row (its cache slot,
    token, logprob sum and position) is gated on it being unfinished at the
    step's start, so a step after a row finished changes nothing there and
    the host may read all-rows-finished once a chunk. The sample-begin mask
    was applied in the verify pass: positions here are past every prompt."""
    eot = token_layout(dec.n_vocab).eot
    t_max = state.tokens.shape[1]
    pos = state.pos
    for _ in range(n_steps):
        live = ~state.finished
        prev = (pos - 1).clamp_min(0)
        last = torch.gather(state.tokens, 1, prev[:, None])[:, 0]
        logits = _decoder_step(dec, last, prev, state.cache, cross_kv, gate=live)
        logits = logits + state.suppress
        logprobs = torch.log_softmax(logits, dim=-1)
        next_tok = torch.where(live, torch.argmax(logits, dim=-1), eot)
        tok_lp = torch.gather(logprobs, 1, next_tok[:, None])[:, 0]
        state.sum_lp.add_(torch.where(live, tok_lp, 0.0))
        wcol = pos.clamp_max(t_max - 1)[:, None]
        state.tokens.scatter_(1, wcol, torch.where(
            live[:, None], next_tok[:, None], torch.gather(state.tokens, 1, wcol)))
        done = (next_tok == eot) | (pos + 1 >= t_max)
        pos.add_(live.long())
        state.finished.logical_or_(done)


def finish_drafted(state: DraftState, p_len: int,
                   no_speech_prob: torch.Tensor) -> DraftedResult:
    """The result of a drafted decode, copied out of ``state``: length =
    index of the first eot at or after the prompt, else ``p_len +
    max_new``."""
    tokens = state.tokens
    t_max = tokens.shape[1]
    eot = token_layout(state.suppress.shape[0]).eot
    is_eot = (tokens == eot) & (torch.arange(t_max, device=tokens.device)[None, :] >= p_len)
    first_eot = torch.where(is_eot.any(dim=1), torch.argmax(is_eot.to(torch.int32), dim=1),
                            torch.full_like(state.pos, t_max))
    return DraftedResult(tokens.clone(), first_eot, state.sum_lp.clone(), no_speech_prob,
                         state.n_accepted.clone())


def greedy_decode_drafted(
    model: Whisper,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    draft: torch.Tensor,
    draft_len: torch.Tensor,
    max_new_tokens: int,
    *,
    suppress_blank: bool = True,
    sot_pos: int = 0,
    cross_kv: Optional[CrossKV] = None,
) -> DraftedResult:
    """Greedy decode that verifies a per-row draft before generating, the
    JAX package's ``greedy_decode_drafted``, uncaptured: token-identical to
    :func:`greedy_decode` for any draft (exact in float32; in bfloat16 the
    verify pass's M=width products and the step's M=1 products sum in other
    orders, so a near-tie may flip). draft (B, D), D <= ``max_new_tokens``,
    eot-padded past ``draft_len``. :func:`start_drafted`, then chunks of
    :func:`_drafted_chunk` while a row is unfinished, then
    :func:`finish_drafted`."""
    dec = model.decoder
    device = enc_out.device
    b, p_len = prompt.shape
    state = init_draft_state(model.config, b, p_len, max_new_tokens, draft.shape[1],
                             dec.decoder_policy.cache_dtype(enc_out.dtype), device)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(dec, enc_out)
    no_speech_prob = start_drafted(
        dec, state, prompt.to(device=device, dtype=torch.long), prompt_len.to(device),
        draft.to(device=device, dtype=torch.long), draft_len.to(device), cross_kv,
        suppress_blank=suppress_blank, sot_pos=sot_pos,
    )
    for done in range(0, max_new_tokens, FINISH_CHECK_EVERY):
        if bool(state.finished.all()):
            break
        _drafted_chunk(dec, state, cross_kv, min(FINISH_CHECK_EVERY, max_new_tokens - done))
    return finish_drafted(state, p_len, no_speech_prob)


# ---------------------------------------------------------------------------
# Beam search (the `accurate` decode profile)
# ---------------------------------------------------------------------------

# the JAX package's score of a beam that may not be chosen and of an empty
# pool entry (``neg_inf = float32(-1e9)`` in ``beam_decode``)
BEAM_NEG = -1e9
MAX_BEAM = 8  # stt_tpu/engine/engine.py:_beam_size_of clamps to 1..8


def beam_candidates(beam_size: int, patience: float) -> int:
    """Finished hypotheses collected per row: ``round(beam_size *
    patience)``, at least the beam (openai-whisper's patience). Equal to the
    beam, the frozen-slot search runs; above it, the pooled one."""
    return max(beam_size, int(round(beam_size * float(patience))))


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order with their indices, a tie going to the lower index.
    ``torch.topk`` promises no order among equal values, and beam scores tie
    (-1e9 plus a log-probability rounds to -1e9; empty pool entries all read
    -1e9), so the selection runs on unique int64 keys: the float's bits
    mapped to an order-preserving integer (-0.0 below 0.0, as in XLA's
    total order), then the index reversed in the low bits."""
    n = x.shape[-1]
    shift = 1 << max(1, (n - 1).bit_length())
    bits = x.contiguous().view(torch.int32)
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
    key = mono * shift + (n - 1 - torch.arange(n, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


class BeamState(NamedTuple):
    """Everything a beam search reads and writes, allocated once for a
    (rows B, beam K, candidates C, prompt length, max_new) shape and updated
    in place, so a CUDA graph of :func:`_beam_chunk` can be replayed against
    it. Beam rows are ordered (B, K), as the JAX package repeats them. The
    pool exists only for the pooled search (C > K)."""

    tokens: torch.Tensor       # (B, K, T_max) int64: prompt + generated, eot-padded
    cache: KVCache             # self-attention K/V, (L, B*K, H, T_max, Dh)
    pos: torch.Tensor          # () int64: the position the next step writes
    p_len: torch.Tensor        # () int64: the prompt's width
    finished: torch.Tensor     # (B, K) bool (frozen-slot search)
    sum_lp: torch.Tensor       # (B, K) float32: beam scores
    prompt_len: torch.Tensor   # (B,) int64: each row's logical prompt length
    suppress: torch.Tensor     # (V,) float32: :func:`_suppress_mask`
    begin_blank: torch.Tensor  # (V,) float32: :func:`_sample_begin_mask`
    begin: torch.Tensor        # (V,) float32: ``begin_blank`` or zeros, per call
    eot_only: torch.Tensor     # (V,) float32: a finished beam's continuation
    pool_tokens: Optional[torch.Tensor]  # (B, C, T_max) int64
    pool_lp: Optional[torch.Tensor]      # (B, C) float32, BEAM_NEG when empty
    pool_len: Optional[torch.Tensor]     # (B, C) int64: index of the eot
    rules: Rules                         # the route's state, rows (B, K)


def init_beam_state(config: WhisperConfig, batch: int, beam: int, candidates: int,
                    p_len: int, max_new: int, dtype: torch.dtype,
                    device: torch.device, *, route: Route = GREEDY,
                    cache: Optional[KVCache] = None) -> BeamState:
    """Zeroed beam state for ``batch`` rows of ``beam`` beams on ``route``
    (never sampled), with a pool of ``candidates`` entries when that
    exceeds the beam; the self cache of B*K rows in ``dtype``, or ``cache``
    (of that shape) when given."""
    if route.sampled:
        raise ValueError("beam search does not sample")
    t_max = p_len + max_new
    layout = token_layout(config.n_vocab)
    eot_only = np.full(config.n_vocab, BEAM_NEG, np.float32)
    eot_only[layout.eot] = 0.0
    pooled = candidates > beam
    suppress, begin_blank = _route_masks(config, route)

    def const(mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(device)

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BeamState(
        tokens=zeros(batch, beam, t_max),
        cache=init_kv_cache(config, batch * beam, t_max, dtype, device) if cache is None
        else cache,
        pos=zeros(),
        p_len=zeros(),
        finished=zeros(batch, beam, dtype=torch.bool),
        sum_lp=zeros(batch, beam, dtype=torch.float32),
        prompt_len=zeros(batch),
        suppress=const(suppress),
        begin_blank=const(begin_blank),
        begin=zeros(config.n_vocab, dtype=torch.float32),
        eot_only=const(eot_only),
        pool_tokens=zeros(batch, candidates, t_max) if pooled else None,
        pool_lp=zeros(batch, candidates, dtype=torch.float32) if pooled else None,
        pool_len=zeros(batch, candidates) if pooled else None,
        rules=init_rules(config, (batch, beam), route, device),
    )


def repeat_cross_kv(ckv: CrossKV, beam: int, out: Optional[CrossKV] = None) -> CrossKV:
    """Cross K/V of B rows repeated over ``beam`` beams, rows in (B, K)
    order: what the JAX package computes from ``jnp.repeat(enc_out, k)``,
    since every row's K/V (and int8 scales) depend on that row alone. With
    ``out`` (buffers of B*K rows) written in place and returned."""
    if out is None:
        return CrossKV(*(None if t is None else t.repeat_interleave(beam, dim=1)
                         for t in ckv))
    for src, dst in zip(ckv, out):
        if src is not None:
            l, b = src.shape[:2]
            dst.view(l, b, beam, *src.shape[2:]).copy_(src[:, :, None])
    return out


def start_beam(dec: TextDecoder, state: BeamState, prompt: torch.Tensor,
               prompt_len: torch.Tensor, cross_kv: CrossKV, *,
               suppress_blank: bool = True, sot_pos: int = 0,
               rep_penalty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reset ``state`` for a new group (``stt_tpu/models/whisper.py:
    2157-2173``): every beam holds the prompt (B, P), eot past it; position
    P; beam 0 scores 0 and the others -1e9, so the first expansion
    diversifies; the pool empty; the route's rules reset, every beam with
    its row's seen-set. The prefill runs on all B*K rows (``cross_kv`` of
    B*K rows); returns p(no_speech) of beam 0 at ``sot_pos``."""
    layout = token_layout(dec.n_vocab)
    b, k, t_max = state.tokens.shape
    p_len = prompt.shape[1]
    state.tokens.fill_(layout.eot)
    state.tokens[:, :, :p_len].copy_(prompt[:, None, :])
    state.prompt_len.copy_(prompt_len)
    state.pos.fill_(p_len)
    state.p_len.fill_(p_len)
    state.finished.zero_()
    state.sum_lp.fill_(BEAM_NEG)
    state.sum_lp[:, 0] = 0.0
    if suppress_blank:
        state.begin.copy_(state.begin_blank)
    else:
        state.begin.zero_()
    if state.pool_lp is not None:
        state.pool_tokens.fill_(layout.eot)
        state.pool_lp.fill_(BEAM_NEG)
        state.pool_len.fill_(p_len)
    reset_rules(state.rules, state.tokens[:, 0], prompt_len, p_len, rep_penalty=rep_penalty)
    nsp = _prefill(dec, state.tokens.view(b * k, t_max), p_len, state.cache, cross_kv,
                   sot_pos, layout)
    return nsp.view(b, k)[:, 0]


def beam_running(state: BeamState) -> torch.Tensor:
    """0-d bool: whether the JAX loop's condition holds, i.e. the next step
    runs. Frozen-slot: a position is left and some beam is unfinished
    (``:2204-2208``); pooled: a position is left and some row's pool has a
    free entry (``:1946-1952``)."""
    left = state.pos < state.tokens.shape[2]
    if state.pool_lp is None:
        return left & ~state.finished.all()
    full = (state.pool_lp > BEAM_NEG / 2).sum(dim=1) >= state.pool_lp.shape[1]
    return left & ~full.all()


def _beam_logprobs(dec: TextDecoder, st: BeamState, cross_kv: CrossKV,
                   run: torch.Tensor, begin_at: torch.Tensor) -> torch.Tensor:
    """One decoder step over every beam row at ``pos - 1`` (its cache write
    gated by ``run``), the route's penalty and bans, the suppress mask and,
    where ``begin_at``, the begin mask, then the timestamp rules on a
    timestamp route: log-probabilities (B, K, V)."""
    b, k, t_max = st.tokens.shape
    rows = st.tokens.view(b * k, t_max)
    last = rows.index_select(1, st.pos.reshape(1) - 1)[:, 0]
    logits = _decoder_step(dec, last, st.pos - 1, st.cache, cross_kv, gate=run)
    logits = _penalise(st.rules, logits.view(b, k, -1), rows, st.pos)
    logits = logits + st.suppress + torch.where(begin_at, st.begin, 0.0)
    if st.rules.last_ts is not None:
        logits = _ts_apply(st.rules, logits, st.pos - st.p_len)
    return torch.log_softmax(logits, dim=-1)


def _gather_beams(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Rows of x (B, K', ...) picked by ``parent`` (B, N): (B, N, ...)."""
    index = parent.reshape(*parent.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, index.expand(*parent.shape, *x.shape[2:]))


def _commit_beams(st: BeamState, run: torch.Tensor, parent: torch.Tensor,
                  new_tok: torch.Tensor) -> None:
    """Reorder the beams by ``parent`` (B, K) and append ``new_tok`` at
    ``pos``, where ``run``; the self cache is gathered by parent on the
    flattened B*K axis and written back in place (an identity gather when
    not running). Advances ``pos`` by ``run``."""
    b, k, t_max = st.tokens.shape
    parent = torch.where(run, parent, torch.arange(k, device=parent.device))
    tokens = _gather_beams(st.tokens, parent)
    at = st.pos.clamp(max=t_max - 1).reshape(1)  # past T_max only when not running
    tokens.index_copy_(2, at, new_tok[:, :, None])
    st.tokens.copy_(torch.where(run, tokens, st.tokens))
    rows = (torch.arange(b, device=parent.device)[:, None] * k + parent).reshape(-1)
    for buf in map(_raw, st.cache):
        buf.copy_(buf.index_select(1, rows))
    st.pos.add_(run.to(st.pos.dtype))


def _beam_step(dec: TextDecoder, st: BeamState, cross_kv: CrossKV) -> None:
    """One step of the frozen-slot search (``stt_tpu/models/whisper.py:
    2210-2270``), every update gated on the loop's condition at the step's
    start: a finished beam continues with ``eot_only`` (its score frozen),
    the best K of the K*V candidates become the beams."""
    b, k, _ = st.tokens.shape
    v = st.suppress.shape[0]
    eot = token_layout(v).eot
    run = beam_running(st)
    logprobs = _beam_logprobs(dec, st, cross_kv, run,
                              (st.pos == st.prompt_len)[:, None, None])
    step_lp = torch.where(st.finished[:, :, None], st.eot_only, logprobs)
    top_vals, top_idx = _top_k((st.sum_lp[:, :, None] + step_lp).view(b, k * v), k)
    parent, new_tok = top_idx // v, top_idx % v
    was_finished = torch.gather(st.finished, 1, parent)
    _advance_rules(st.rules, new_tok, ~was_finished, eot, parent, run)
    finished = was_finished | (new_tok == eot)
    st.finished.copy_(torch.where(run, finished, st.finished))
    st.sum_lp.copy_(torch.where(run, top_vals, st.sum_lp))
    _commit_beams(st, run, parent, new_tok)


def _beam_pooled_step(dec: TextDecoder, st: BeamState, cross_kv: CrossKV) -> None:
    """One step of the pooled search (``stt_tpu/models/whisper.py:
    1954-2042``), gated as :func:`_beam_step`: the best 2K candidates; those
    ending in eot are banked into the pool (the best C of pool and
    newcomers stay), the best K others stay live."""
    b, k, t_max = st.tokens.shape
    c = st.pool_lp.shape[1]
    v = st.suppress.shape[0]
    eot = token_layout(v).eot
    run = beam_running(st)
    logprobs = _beam_logprobs(dec, st, cross_kv, run, st.pos == st.p_len)
    top_vals, top_idx = _top_k((st.sum_lp[:, :, None] + logprobs).view(b, k * v), 2 * k)
    parent, new_tok = top_idx // v, top_idx % v
    is_eot = new_tok == eot

    cand_tokens = _gather_beams(st.tokens, parent)
    cand_tokens.index_fill_(2, st.pos.clamp(max=t_max - 1).reshape(1), eot)
    merged_lp = torch.cat([st.pool_lp, torch.where(is_eot, top_vals, BEAM_NEG)], dim=1)
    merged_len = torch.cat([st.pool_len, st.pos.expand(b, 2 * k)], dim=1)
    pool_lp, keep = _top_k(merged_lp, c)
    pool_tokens = _gather_beams(torch.cat([st.pool_tokens, cand_tokens], dim=1), keep)
    st.pool_tokens.copy_(torch.where(run, pool_tokens, st.pool_tokens))
    st.pool_len.copy_(torch.where(run, torch.gather(merged_len, 1, keep), st.pool_len))
    st.pool_lp.copy_(torch.where(run, pool_lp, st.pool_lp))

    sum_lp, live = _top_k(torch.where(is_eot, BEAM_NEG, top_vals), k)
    st.sum_lp.copy_(torch.where(run, sum_lp, st.sum_lp))
    live_parent, live_tok = torch.gather(parent, 1, live), torch.gather(new_tok, 1, live)
    _advance_rules(st.rules, live_tok, torch.ones_like(live_tok, dtype=torch.bool), eot,
                   live_parent, run)
    _commit_beams(st, run, live_parent, live_tok)


def _beam_chunk(dec: TextDecoder, state: BeamState, cross_kv: CrossKV,
                n_steps: int = FINISH_CHECK_EVERY) -> None:
    """``n_steps`` beam steps on ``state`` in place (the pooled search when
    the state has a pool), reading and writing only its buffers and
    ``cross_kv`` of B*K rows, with no host read. A step after the loop's
    condition fails changes nothing, so the host may read
    :func:`beam_running` once a chunk and get the JAX loop's result."""
    step = _beam_step if state.pool_lp is None else _beam_pooled_step
    for _ in range(n_steps):
        step(dec, state, cross_kv)


def finish_beam(state: BeamState, p_len: int, no_speech_prob: torch.Tensor,
                length_penalty: float = 1.0) -> DecodeResult:
    """The best hypothesis per row, copied out of the state, in
    :class:`DecodeResult`'s layout. Scores are ``sum / gen_len **
    length_penalty`` (CTranslate2's normalisation). Frozen-slot
    (``:2283-2309``): a beam's length is its first eot at or after the
    prompt, else ``pos``; finished beams are preferred. Pooled
    (``:2053-2078``): the pool's entries, the live beams only when a row's
    pool is empty."""
    tokens, sum_lp, pos = state.tokens, state.sum_lp, state.pos
    b, k, t_max = tokens.shape
    eot = token_layout(state.suppress.shape[0]).eot
    live_len = pos.expand(b, k)
    if state.pool_lp is None:
        is_eot = (tokens == eot) & (torch.arange(t_max, device=tokens.device) >= p_len)
        lengths = torch.where(is_eot.any(dim=2),
                              torch.argmax(is_eot.to(torch.int32), dim=2), live_len)
        gen = torch.clamp_min(lengths - p_len, 1).to(torch.float32)
        avg = sum_lp / gen ** length_penalty
        blocked = state.finished.any(dim=1, keepdim=True) & ~state.finished
        score, lp = torch.where(blocked, BEAM_NEG, avg), sum_lp
    else:
        banked = state.pool_lp > BEAM_NEG / 2
        pool_gen = torch.clamp_min(state.pool_len - p_len, 1).to(torch.float32)
        pool_avg = torch.where(banked, state.pool_lp / pool_gen ** length_penalty, BEAM_NEG)
        live_gen = torch.clamp_min(live_len - p_len, 1).to(torch.float32)
        live_avg = torch.where(banked.any(dim=1, keepdim=True), BEAM_NEG,
                               sum_lp / live_gen ** length_penalty)
        score = torch.cat([pool_avg, live_avg], dim=1)
        lp = torch.cat([state.pool_lp, sum_lp], dim=1)
        lengths = torch.cat([state.pool_len, live_len], dim=1)
        tokens = torch.cat([state.pool_tokens, tokens], dim=1)
    best = torch.argmax(score, dim=1)
    rows = torch.arange(b, device=tokens.device)
    return DecodeResult(tokens[rows, best].clone(), lengths[rows, best].clone(),
                        lp[rows, best].clone(), no_speech_prob)


def beam_decode(
    model: Whisper,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    max_new_tokens: int,
    *,
    beam_size: int = 5,
    patience: float = 1.0,
    length_penalty: float = 1.0,
    suppress_blank: bool = True,
    sot_pos: int = 0,
    cross_kv: Optional[CrossKV] = None,
    rep_penalty: Optional[torch.Tensor] = None,
    ngram_n: int = 0,
    with_timestamps: bool = False,
) -> DecodeResult:
    """Batched beam search, uncaptured: the JAX package's ``beam_decode``
    (``rep_penalty`` (B,), when given, takes the penalised route; ``ngram_n``
    bans repeated n-grams; ``with_timestamps`` applies the timestamp
    grammar per beam, the prompt then without ``no_timestamps``). The
    frozen-slot search when ``round(beam_size * patience) <= beam_size``, else the
    pooled one. enc_out (B, T_a, d); prompt (B, P) right-padded with eot
    past ``prompt_len``; ``cross_kv``, when given, holds B*K rows (else it
    is computed from ``enc_out`` and repeated over the beams). Runs chunks
    of ``FINISH_CHECK_EVERY`` steps and stops after the first chunk after
    which the loop's condition fails. Returns the best beam per row."""
    dec = model.decoder
    device = enc_out.device
    b, p_len = prompt.shape
    k = beam_size
    route = Route(timestamps=with_timestamps, penalised=rep_penalty is not None,
                  ngram_n=int(ngram_n))
    state = init_beam_state(model.config, b, k, beam_candidates(k, patience), p_len,
                            max_new_tokens, dec.decoder_policy.cache_dtype(enc_out.dtype),
                            device, route=route)
    if cross_kv is None:
        cross_kv = repeat_cross_kv(precompute_cross_kv(dec, enc_out), k)
    no_speech_prob = start_beam(
        dec, state, prompt.to(device=device, dtype=torch.long), prompt_len.to(device),
        cross_kv, suppress_blank=suppress_blank, sot_pos=sot_pos,
        rep_penalty=None if rep_penalty is None else rep_penalty.to(device),
    )
    for done in range(0, max_new_tokens, FINISH_CHECK_EVERY):
        _beam_chunk(dec, state, cross_kv, min(FINISH_CHECK_EVERY, max_new_tokens - done))
        if not bool(beam_running(state)):
            break
    return finish_beam(state, p_len, no_speech_prob, length_penalty)


def detect_language(model: Whisper, enc_out: torch.Tensor,
                    cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
    """(B, n_langs) language probabilities from the sot logits."""
    config = model.config
    layout = token_layout(config.n_vocab)
    b = enc_out.shape[0]
    if cross_kv is None:
        cross_kv = precompute_cross_kv(model.decoder, enc_out)
    cache = init_kv_cache(config, b, 4, model.decoder.decoder_policy.cache_dtype(enc_out.dtype),
                          enc_out.device)
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
    "BeamState",
    "DecoderPolicy",
    "CrossKV",
    "DecodeResult",
    "DecodeState",
    "DraftState",
    "DraftedResult",
    "GREEDY",
    "KVCache",
    "Route",
    "Rules",
    "TokenLayout",
    "WHISPER_LANG_CODES",
    "Whisper",
    "WhisperConfig",
    "beam_candidates",
    "beam_decode",
    "beam_running",
    "build_model",
    "build_prompt",
    "compression_ratio",
    "cross_attention_weights",
    "decode_sources",
    "decoder_forward",
    "detect_language",
    "empty_cross_kv",
    "finish_decode",
    "finish_drafted",
    "fuse_decoder_qkv",
    "get_config",
    "finish_beam",
    "greedy_decode",
    "greedy_decode_drafted",
    "greedy_decode_timestamps",
    "gumbel_noise",
    "init_beam_state",
    "init_decode_state",
    "init_draft_state",
    "init_kv_cache",
    "init_params",
    "init_rules",
    "load_hf_safetensors",
    "precompute_cross_kv",
    "quantize_decoder_weights",
    "repeat_cross_kv",
    "reset_rules",
    "sample_decode",
    "split_timestamp_segments",
    "start_beam",
    "start_decode",
    "start_drafted",
    "token_layout",
]
