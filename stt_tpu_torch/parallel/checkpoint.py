"""HF-compatible checkpoint export, the writer half of
``stt_tpu/parallel/checkpoint.py`` (``export_hf_safetensors``): a
parameter tree written as a ``WhisperForConditionalGeneration``-layout
directory (``model.safetensors`` + ``config.json``) that ``weights_path``
serves and :func:`stt_tpu_torch.models.whisper.load_hf_safetensors` reads.
It writes through the port's own safetensors writer
(:mod:`stt_tpu_torch.utils.safetensors_io`), so no ``safetensors`` package
is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..utils.safetensors_io import write_safetensors


def _unstack(stacked: Dict[str, Any], n_layers: int):
    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else np.asarray(v[i])
                for k, v in tree.items()}
    return [take(stacked, i) for i in range(n_layers)]


def export_hf_safetensors(path: str, params: Dict[str, Any], config,
                          dtype: torch.dtype = torch.float32) -> int:
    """Write a JAX-layout parameter tree (numpy leaves, as
    :func:`~stt_tpu_torch.models.whisper.init_params` gives and
    :func:`~stt_tpu_torch.convert.to_jax_params` makes of a model) to the
    checkpoint directory ``path``, every tensor in ``dtype`` (float32 by
    default, as the JAX package writes; bfloat16 or float16 halve the
    file). Returns the bytes of ``model.safetensors``."""
    os.makedirs(path, exist_ok=True)
    t: Dict[str, np.ndarray] = {}

    def put_linear(prefix, leaf, bias=True):
        t[f"{prefix}.weight"] = np.asarray(leaf["w"]).T
        if bias and "b" in leaf:
            t[f"{prefix}.bias"] = np.asarray(leaf["b"])

    def put_ln(prefix, leaf):
        t[f"{prefix}.weight"] = np.asarray(leaf["g"])
        t[f"{prefix}.bias"] = np.asarray(leaf["b"])

    def put_attn(prefix, leaf):
        put_linear(f"{prefix}.q_proj", leaf["q"])
        put_linear(f"{prefix}.k_proj", leaf["k"], bias=False)
        put_linear(f"{prefix}.v_proj", leaf["v"])
        put_linear(f"{prefix}.out_proj", leaf["o"])

    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):
        t[f"encoder.{name}.weight"] = np.asarray(enc[name]["w"]).transpose(2, 1, 0)
        t[f"encoder.{name}.bias"] = np.asarray(enc[name]["b"])
    t["encoder.embed_positions.weight"] = np.asarray(enc["pos"])
    put_ln("encoder.layer_norm", enc["ln_post"])
    for i, block in enumerate(_unstack(enc["blocks"], config.n_audio_layer)):
        p = f"encoder.layers.{i}"
        put_ln(f"{p}.self_attn_layer_norm", block["ln1"])
        put_attn(f"{p}.self_attn", block["attn"])
        put_ln(f"{p}.final_layer_norm", block["ln2"])
        put_linear(f"{p}.fc1", block["mlp"]["fc1"])
        put_linear(f"{p}.fc2", block["mlp"]["fc2"])

    t["decoder.embed_tokens.weight"] = np.asarray(dec["tok"])
    t["decoder.embed_positions.weight"] = np.asarray(dec["pos"])
    put_ln("decoder.layer_norm", dec["ln"])
    for i, block in enumerate(_unstack(dec["blocks"], config.n_text_layer)):
        p = f"decoder.layers.{i}"
        put_ln(f"{p}.self_attn_layer_norm", block["ln1"])
        put_attn(f"{p}.self_attn", block["attn"])
        put_ln(f"{p}.encoder_attn_layer_norm", block["ln_x"])
        put_attn(f"{p}.encoder_attn", block["xattn"])
        put_ln(f"{p}.final_layer_norm", block["ln2"])
        put_linear(f"{p}.fc1", block["mlp"]["fc1"])
        put_linear(f"{p}.fc2", block["mlp"]["fc2"])

    tensors = {f"model.{k}": torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dtype)
               for k, v in t.items()}
    n_bytes = write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "whisper",
            "architectures": ["WhisperForConditionalGeneration"],
            "num_mel_bins": config.n_mels,
            "d_model": config.n_audio_state,
            "encoder_attention_heads": config.n_audio_head,
            "encoder_layers": config.n_audio_layer,
            "encoder_ffn_dim": 4 * config.n_audio_state,
            "decoder_ffn_dim": 4 * config.n_text_state,
            "activation_function": "gelu",
            "vocab_size": config.n_vocab,
            "decoder_attention_heads": config.n_text_head,
            "decoder_layers": config.n_text_layer,
            "max_source_positions": config.n_audio_ctx,
            "max_target_positions": config.n_text_ctx,
        }, f)
    return n_bytes


__all__ = ["export_hf_safetensors"]
