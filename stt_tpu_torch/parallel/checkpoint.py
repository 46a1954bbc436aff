"""Checkpoints: the training state of the sharded trainer, and an
HF-compatible export. Counterpart of ``stt_tpu/parallel/checkpoint.py``.

- :func:`save_checkpoint` / :func:`restore_checkpoint` take the place of
  orbax's (``save_checkpoint``, ``restore_checkpoint``): one ``torch.save``
  file of the full, unsharded parameters, the AdamW moments and step
  counts gathered from every model slot's shard, and the step. A restore
  cuts them again for the trainer's own mesh, as orbax restores into the
  template's shardings, so a checkpoint taken on one mesh restores on
  another. Every rank calls both; rank 0 writes the file.
- :func:`export_hf_safetensors`: a parameter tree written as a
  ``WhisperForConditionalGeneration``-layout directory
  (``model.safetensors`` + ``config.json``) that ``weights_path`` serves
  and :func:`stt_tpu_torch.models.whisper.load_hf_safetensors` reads,
  through the port's own safetensors writer
  (:mod:`stt_tpu_torch.utils.safetensors_io`), so no ``safetensors``
  package is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.safetensors_io import write_safetensors
from .sharding import shard_of, split_dim


def save_checkpoint(path: str, trainer, state, step: Optional[int] = None) -> None:
    """Write ``state`` (a :class:`~.trainer.TrainState` of ``trainer``) to the
    file ``path``: full parameters and AdamW state on the host, and the step
    (``state.step`` unless given). Collective: every rank of the trainer's
    mesh calls it."""
    import torch.distributed as dist

    names = {id(p): n for n, p in state.model.named_parameters()}
    params = {n: trainer.gather_full(n, p).cpu() for n, p in state.model.named_parameters()}
    opt = {}
    for p, st in state.optimizer.state.items():
        name = names[id(p)]
        opt[name] = {k: trainer.gather_full(name, v).cpu() if v.ndim else v.detach().cpu().clone()
                     for k, v in st.items()}
    if trainer.rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save({"params": params, "opt_state": opt,
                    "step": state.step if step is None else int(step)}, tmp)
        os.replace(tmp, path)
    if trainer.mesh.size > 1:
        dist.barrier()


def restore_checkpoint(path: str, trainer):
    """A :class:`~.trainer.TrainState` for ``trainer``'s slot from the file
    ``path``: the parameters and AdamW state cut to this slot's shards of
    the trainer's mesh, whatever mesh wrote them, and the step."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    dtype = next(iter(saved["params"].values())).dtype
    state = trainer.init_state(saved["params"], dtype=dtype)
    parts, index = trainer.mesh.model, trainer.model_index
    for name, p in state.model.named_parameters():
        moments = saved["opt_state"].get(name)
        if moments is None:
            continue
        state.optimizer.state[p] = {
            k: (shard_of(v, split_dim(name), index, parts).to(p.device) if v.ndim
                else v.clone())
            for k, v in moments.items()}
    state.step = int(saved["step"])
    return state


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


__all__ = ["export_hf_safetensors", "restore_checkpoint", "save_checkpoint"]
