"""Tensor-parallel layers over a mesh's model axis: Megatron's conjugate
collectives, and the split layers built on them, in two places.

The split rules are ``sharding.py``'s. A layer split by columns (q, k, v,
fc1) holds a column slice of its weight and bias; a layer split by rows (o,
fc2) a row slice of its weight and the whole bias. The forms:

- attention: q, k and v are computed from their column slices and gathered
  to full width before the attention core (so any slice of the columns
  works, whether or not it falls on a head boundary); the o projection
  multiplies its input's slice by its row slice, one reduce, then the bias;
- MLP (Megatron proper): fc1 by columns, GELU on the slice, fc2 by rows,
  one reduce, then the bias.

**Over a process group** (training; one process a slot), three
``torch.autograd.Function`` pairs whose backward is each other's forward:

- :func:`copy_to_model`: identity forward, all-reduce backward: in front
  of every product with split weights, so the gradient of the replicated
  input sums every slot's part;
- :func:`reduce_from_model`: all-reduce forward, identity backward;
- :func:`gather_columns`: all-gather forward, own slice backward.

Only ``all_reduce`` is used, which gloo carries for CUDA tensors too (it
has no all-gather for them, and NCCL refuses two ranks on one card): the
gather is an all-reduce of zero-filled full-width buffers, which is exact.
With no process group (a mesh of one slot needs none) they raise.

**In one process over the slots' devices** (serving): the same products,
one per slot on that slot's device, concatenated or summed on the
caller's device in slot order.

Partial products of a row split are summed in float32 and the bias added
before one rounding to the compute type, as ``_linear`` rounds once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models import whisper as W
from .sharding import split_bounds, split_dim


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        raise RuntimeError("a collective over the model axis needs its process group")
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, width, group):
        ctx.lo, ctx.hi = lo, lo + x.shape[-1]
        full = x.new_zeros(*x.shape[:-1], width)
        full[..., ctx.lo:ctx.hi] = x
        return _all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient over the
    model group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward over the model group; identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_columns(x: torch.Tensor, lo: int, width: int, group) -> torch.Tensor:
    """The full ``width`` columns from every slot's slice (this slot's
    starting at ``lo``); the backward keeps this slot's slice of the
    gradient."""
    return _GatherColumns.apply(x, lo, width, group)


def _partial_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with a float32 result: the card's narrow route
    when serving, upcast operands under grad (float32 training multiplies
    in float32 either way)."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled():
        y = torch.matmul(x2.float(), w.float())
    else:
        y = W._mm_f32(x2, w.to(x.dtype))
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _plain_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``_linear``'s float route on explicit weights."""
    if b is None:
        return torch.matmul(x, w)
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


# -- over a process group (training) ---------------------------------------------


class RankColumn:
    """A column-split layer on one rank: its slice of the output, gathered."""

    def __init__(self, lo: int, width: int, group) -> None:
        self.lo, self.width, self.group = lo, width, group

    def __call__(self, x: torch.Tensor, p: "W.Linear") -> torch.Tensor:
        y = _plain_linear(copy_to_model(x, self.group), p.w, p.b)
        return gather_columns(y, self.lo, self.width, self.group)


class RankRow:
    """A row-split layer on one rank: its input slice times its rows, one
    reduce, then the bias."""

    def __init__(self, lo: int, hi: int, group) -> None:
        self.lo, self.hi, self.group = lo, hi, group

    def __call__(self, x: torch.Tensor, p: "W.Linear") -> torch.Tensor:
        part = copy_to_model(x, self.group)[..., self.lo:self.hi]
        y = reduce_from_model(_partial_f32(part, p.w), self.group)
        if p.b is not None:
            y = y + p.b.float()
        return y.to(x.dtype)


class RankMLP:
    """fc1 by columns, GELU, fc2 by rows, one reduce, the bias."""

    def __init__(self, group) -> None:
        self.group = group

    def __call__(self, x: torch.Tensor, mlp: "W.MLP") -> torch.Tensor:
        h = F.gelu(_plain_linear(copy_to_model(x, self.group), mlp.fc1.w, mlp.fc1.b))
        y = reduce_from_model(_partial_f32(h, mlp.fc2.w), self.group)
        return (y + mlp.fc2.b.float()).to(x.dtype)


def _split_modules(model: nn.Module):
    """(Linear, split dim of its weight) of every split layer, and the
    MLPs."""
    linears = [(mod, split_dim(f"{name}.w")) for name, mod in model.named_modules()
               if isinstance(mod, W.Linear) and split_dim(f"{name}.w") is not None]
    mlps = [mod for mod in model.modules() if isinstance(mod, W.MLP)]
    return linears, mlps


@torch.no_grad()
def shard_model_for_rank(model: W.Whisper, model_index: int, parts: int, group) -> None:
    """Keep model slot ``model_index``'s shard of every split parameter (in
    place, as new parameters of the shard's shape) and route the split
    layers through the model group's collectives. A model axis of one slot
    changes nothing."""
    if parts == 1:
        return
    linears, mlps = _split_modules(model)
    for lin, dim in linears:
        n = lin.w.shape[dim]
        lo, hi = split_bounds(n, parts)[model_index]
        grad = lin.w.requires_grad
        lin.w = nn.Parameter(lin.w.narrow(dim, lo, hi - lo).contiguous(), requires_grad=grad)
        if dim == 1:
            if lin.b is not None:
                lin.b = nn.Parameter(lin.b[lo:hi].contiguous(), requires_grad=grad)
            lin.shard = RankColumn(lo, n, group)
        else:
            lin.shard = RankRow(lo, hi, group)
    for mlp in mlps:
        mlp.shard = RankMLP(group)


# -- in one process over the slots' devices (serving) ---------------------------


class SlotColumn:
    """A column-split layer over the slots: each slot's slice of the output
    on its device, concatenated on the caller's device."""

    def __init__(self, shards: List[Tuple[torch.Tensor, Optional[torch.Tensor]]]) -> None:
        self.shards = shards

    def __call__(self, x: torch.Tensor, p: "W.Linear") -> torch.Tensor:
        return torch.cat([_plain_linear(x.to(w.device), w, b).to(x.device)
                          for w, b in self.shards], dim=-1)


class SlotRow:
    """A row-split layer over the slots: each slot's input slice times its
    rows, summed in float32 in slot order, then the bias, rounded once."""

    def __init__(self, shards: List[torch.Tensor], bounds: Sequence[Tuple[int, int]],
                 bias: Optional[torch.Tensor]) -> None:
        self.shards, self.bounds, self.bias = shards, list(bounds), bias

    def __call__(self, x: torch.Tensor, p: "W.Linear") -> torch.Tensor:
        y = None
        for w, (lo, hi) in zip(self.shards, self.bounds):
            part = _partial_f32(x[..., lo:hi].to(w.device), w).to(x.device)
            y = part if y is None else y + part
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class SlotMLP:
    """fc1 by columns, GELU and fc2 by rows on each slot's device, summed in
    float32 in slot order, then fc2's bias."""

    def __init__(self, shards, bias: torch.Tensor) -> None:
        self.shards, self.bias = shards, bias

    def __call__(self, x: torch.Tensor, mlp: "W.MLP") -> torch.Tensor:
        y = None
        for w1, b1, w2 in self.shards:
            h = F.gelu(_plain_linear(x.to(w1.device), w1, b1))
            part = _partial_f32(h, w2).to(x.device)
            y = part if y is None else y + part
        return (y + self.bias.float()).to(x.dtype)


@torch.no_grad()
def shard_model_for_slots(model: W.Whisper, devices: Sequence[torch.device]) -> None:
    """Split every split layer of a serving model over ``devices`` (one
    tensor-parallel group; a device may repeat): each slot's shard is copied
    to its device, and the layer's full weight is dropped. One device
    changes nothing."""
    parts = len(devices)
    if parts == 1:
        return
    linears, mlps = _split_modules(model)
    fc = {id(m.fc1) for m in mlps} | {id(m.fc2) for m in mlps}
    for lin, dim in linears:
        if id(lin) in fc:
            continue
        bounds = split_bounds(lin.w.shape[dim], parts)
        pieces = [lin.w.narrow(dim, lo, hi - lo).to(d).contiguous()
                  for (lo, hi), d in zip(bounds, devices)]
        if dim == 1:
            biases = [None if lin.b is None else lin.b[lo:hi].to(d).contiguous()
                      for (lo, hi), d in zip(bounds, devices)]
            lin.shard = SlotColumn(list(zip(pieces, biases)))
            lin.b = None
        else:
            lin.shard = SlotRow(pieces, bounds, lin.b)
        lin.w = None
    for mlp in mlps:
        fc1, fc2 = mlp.fc1, mlp.fc2
        bounds = split_bounds(fc1.w.shape[1], parts)
        mlp.shard = SlotMLP([
            (fc1.w[:, lo:hi].to(d).contiguous(), fc1.b[lo:hi].to(d).contiguous(),
             fc2.w[lo:hi].to(d).contiguous())
            for (lo, hi), d in zip(bounds, devices)], fc2.b)
        fc1.w = fc1.b = fc2.w = None


__all__ = ["RankColumn", "RankMLP", "RankRow", "SlotColumn", "SlotMLP", "SlotRow",
           "copy_to_model", "gather_columns", "reduce_from_model", "shard_model_for_rank",
           "shard_model_for_slots"]
