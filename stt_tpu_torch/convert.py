"""Parameter conversion between the JAX package's tree and the port's modules.

The JAX package keeps Whisper's parameters as a nested dict whose
per-layer leaves are stacked on a leading layer axis
(``params["decoder"]["blocks"]["attn"]["q"]["w"]`` has shape (L, d, d)).
The port keeps one ``nn.Module`` per layer, so the same leaf is
``decoder.blocks.{i}.attn.q.w`` in its ``state_dict``. Every other leaf
keeps its name and its layout (linear weights (d_in, d_out), conv
kernels (K, C_in, C_out)), so the two packages compute with the same
arrays. Tests use :func:`from_jax_params` to hand both packages
identical weights. The decoder policies' weight transforms (fused q/k/v,
int8 storage) are not part of this tree: the port applies them to the
converted weights at load, as the JAX engine applies them to its tree
(``stt_tpu_torch.models.whisper.build_model``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf(x) -> np.ndarray:
    """Any array-like leaf (numpy, or a JAX array passed through
    ``np.asarray``) as float32 numpy; bfloat16 widens exactly."""
    arr = np.asarray(x)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            _flatten(sub, key + ".", out)
        else:
            out[key] = _leaf(sub)


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-layout parameter tree (leaves numpy or array-like) -> the port's
    ``state_dict`` (float32 CPU tensors; stacked block leaves split per
    layer). Tensors share memory with float32 numpy leaves."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        flat: Dict[str, np.ndarray] = {}
        blocks = tree[part]["blocks"]
        rest = {k: v for k, v in tree[part].items() if k != "blocks"}
        _flatten(rest, f"{part}.", flat)
        stacked: Dict[str, np.ndarray] = {}
        _flatten(blocks, "", stacked)
        n_layers = {v.shape[0] for v in stacked.values()}
        if len(n_layers) != 1:
            raise ValueError(f"{part} blocks disagree on the layer count: {n_layers}")
        for key, arr in stacked.items():
            for li in range(arr.shape[0]):
                flat[f"{part}.blocks.{li}.{key}"] = arr[li]
        out.update({k: torch.from_numpy(v) for k, v in flat.items()})
    return out


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the JAX package's parameter tree
    (float32 numpy leaves, block leaves stacked on a leading layer axis)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[tuple, Dict[int, np.ndarray]] = {}
    for key, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        parts = key.split(".")
        if len(parts) > 2 and parts[1] == "blocks":
            per_layer.setdefault((parts[0], *parts[3:]), {})[int(parts[2])] = arr
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for (part, *path), layers in per_layer.items():
        node = tree.setdefault(part, {}).setdefault("blocks", {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree


__all__ = ["from_jax_params", "to_jax_params"]
