"""A (data, model) mesh of slots and the split rules for Whisper's parameters.

Counterpart of ``stt_tpu/parallel/sharding.py``. A mesh is a grid of
slots, one device each, with the data axis first: the data axis splits a
batch's rows (one replica of the model per data row), the model axis
splits each layer's widest products Megatron's way, so that a block needs
one reduce for its attention and one for its MLP:

- attention and cross-attention q, k and v: weights (d, d) by columns
  (output dim 1), their biases with them;
- attention and cross-attention o: weights by rows (input dim 0), the bias
  replicated (it is added after the reduce);
- MLP fc1 by columns, with its bias; fc2 by rows, its bias replicated;
- everything else (conv stem, embeddings, position tables, layer norms)
  replicated.

A split dimension of ``n`` values over ``m`` slots gives slot ``i`` the
range :func:`split_bounds` ``(n, m)[i]``: ``torch.tensor_split``'s ranges,
so a model axis need not divide the heads (the "test" config's 2 heads of
32 split 4 ways into column slices of 16, as GSPMD splits them).

Where JAX's mesh is a grid of devices that XLA programs with collectives,
the port runs the rules in two places (``collectives.py``): over a
``torch.distributed`` process group, one process a slot, in training; in
one process over the slots' devices, in serving. A slot names a device,
and two slots may name the same device: ``["cpu"] * 8`` on the host, or
``["cuda:0", "cuda:0"]`` on one card, stand in for the JAX tests' forced
host device count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_COLUMN_SPLIT = ("q", "k", "v", "fc1")
_ROW_SPLIT = ("o", "fc2")


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of slots; ``devices`` in row-major order, so
    slot (i, j) is ``devices[i * model + j]``, which is also the process
    rank that holds it in training."""

    shape: Tuple[int, int]
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, model index) of slot ``rank``."""
        return divmod(rank, self.model)

    def model_row(self, data_index: int = 0) -> Tuple[torch.device, ...]:
        """The devices of one data row: one tensor-parallel group."""
        return self.devices[data_index * self.model:(data_index + 1) * self.model]

    def model_ranks(self, data_index: int) -> List[int]:
        return [data_index * self.model + j for j in range(self.model)]

    def data_ranks(self, model_index: int) -> List[int]:
        return [i * self.model + model_index for i in range(self.data)]


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("build_mesh without devices needs CUDA cards (pass devices= "
                           "to build a mesh of CPU slots)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(shape: Optional[Tuple[int, int]] = None,
               devices: Optional[Sequence[Union[str, torch.device]]] = None,
               axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A 2-D mesh over ``devices`` (default: every visible card). With no
    ``shape`` every slot is on the data axis (pure replication). Raises if
    the shape does not match the slot count, as
    ``stt_tpu/parallel/sharding.py:build_mesh`` does."""
    devs = tuple(torch.device(d) for d in (devices if devices is not None
                                           else _visible_devices()))
    n = len(devs)
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh shape {shape} is not (data, model) of positive sizes")
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not match device count {n}")
    return Mesh(shape, devs, tuple(axis_names))


def split_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of ``parts`` consecutive pieces of ``n`` values, the
    first ``n % parts`` one longer (``torch.tensor_split``'s ranges)."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (1 if i < r else 0)
        out.append((lo, hi))
        lo = hi
    return out


def split_dim(name: str) -> Optional[int]:
    """The split dimension of one of the port's parameters on the model
    axis (``stt_tpu/parallel/sharding.py:_spec_for_path`` for the unstacked
    leaf), or None for a replicated one."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] not in ("w", "b"):
        return None
    layer, leaf = parts[-2], parts[-1]
    in_attn = "attn" in parts or "xattn" in parts
    in_mlp = "mlp" in parts
    if (in_attn and layer in ("q", "k", "v")) or (in_mlp and layer == "fc1"):
        return 1 if leaf == "w" else 0
    if (in_attn and layer == "o") or (in_mlp and layer == "fc2"):
        return 0 if leaf == "w" else None
    return None


def whisper_param_specs(params: Dict[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """The split dimension (or None) of every entry of a state dict."""
    return {name: split_dim(name) for name in params}


def shard_of(tensor: torch.Tensor, dim: Optional[int], index: int, parts: int) -> torch.Tensor:
    """Slot ``index``'s piece of ``tensor`` along ``dim`` (all of it when
    ``dim`` is None), as a contiguous copy."""
    if dim is None:
        return tensor.clone()
    lo, hi = split_bounds(tensor.shape[dim], parts)[index]
    return tensor.narrow(dim, lo, hi - lo).contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 model_index: int) -> Dict[str, torch.Tensor]:
    """The state dict that model slot ``model_index`` holds under the split
    rules."""
    return {name: shard_of(t, split_dim(name), model_index, mesh.model)
            for name, t in params.items()}


def unshard_params(shards: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The full state dict from every model slot's shard, in slot order
    (the inverse of :func:`shard_params`)."""
    out = {}
    for name, first in shards[0].items():
        dim = split_dim(name)
        out[name] = first.clone() if dim is None else torch.cat(
            [s[name] for s in shards], dim=dim)
    return out


def batch_sharding(mesh: Mesh, rows: int, data_index: int) -> slice:
    """The rows of a batch that data row ``data_index`` takes; a row count
    the data axis does not divide raises, as the JAX batch sharding
    ``P(DATA_AXIS)`` does."""
    if rows % mesh.data:
        raise ValueError(f"batch of {rows} rows does not split over the data axis of "
                         f"{mesh.data}")
    per = rows // mesh.data
    return slice(data_index * per, (data_index + 1) * per)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "batch_sharding", "build_mesh", "shard_of",
           "shard_params", "split_bounds", "split_dim", "unshard_params",
           "whisper_param_specs"]
