"""Sharded fine-tune train step for Whisper: data x tensor parallel over a
(data, model) mesh, one process a slot.

Counterpart of ``stt_tpu/parallel/trainer.py``: teacher-forced masked
cross entropy on ``decoder_forward`` (:func:`loss_fn`), AdamW with optax's
``adamw`` settings (:func:`make_optimizer`), and :class:`ShardedTrainer`,
whose ``train_step`` takes one step on this process's slot:

- **Ranks.** Slot (i, j) of a (d, m) mesh is process rank i * m + j of a
  ``torch.distributed`` group the caller has initialised (gloo on the
  host; two ranks may share one card, since only ``all_reduce`` is used).
  A mesh of one slot needs no group.
- **The data axis** splits the batch's rows (:func:`~.sharding.
  batch_sharding`; a row count it does not divide raises). The loss
  divides each rank's masked sum by the *global* mask count, all-reduced
  over the data group first, so that the summed gradients are those of
  JAX's ``-(token_lp * mask).sum() / max(mask.sum(), 1)`` over the whole
  batch whatever the masks of each rank (averaging each rank's mean, as
  DDP does, is wrong whenever they differ). Gradients are then summed over
  the data group.
- **The model axis** splits q, k, v, o, fc1 and fc2 of every layer
  (``collectives.py``); replicated parameters get the full gradient on
  every model rank through the copy-to-model function in front of every
  split product, so they need no reduce over the model group.
- The model trains in the type of its parameters (float32 from
  ``init_params``, bfloat16 if given bfloat16), as the JAX trainer does,
  with the attention policy's flash attention (its kernels and their
  backward on the card, at 512 positions or more). On the card a step's
  products and convolutions run with TF32 off (restored after the step):
  float32 training stays float32, so its gradients can be held against
  the CPU's and against plain attention's.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import whisper as W
from .collectives import shard_model_for_rank
from .sharding import Mesh, batch_sharding, split_bounds, split_dim


class TrainBatch(NamedTuple):
    """One teacher-forced batch (numpy arrays or tensors).

    mel: (B, n_mels, T_frames) log-mel features
    tokens: (B, T) int decoder inputs (sot prompt + transcript + eot)
    loss_mask: (B, T) float32, 1.0 on positions whose NEXT token is a label
    """

    mel: Any
    tokens: Any
    loss_mask: Any


def masked_logprob_sums(model: W.Whisper, batch: TrainBatch):
    """(Σ token log-prob x mask, Σ mask) of next-token prediction over a
    batch of tensors on the model's device, both float32 0-d tensors."""
    enc = model.encoder(batch.mel)
    logits = W.decoder_forward(model, batch.tokens, enc)[:, :-1, :]
    labels = batch.tokens[:, 1:]
    mask = batch.loss_mask[:, 1:].float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    token_lp = torch.gather(logprobs, -1, labels[..., None].long())[..., 0]
    return (token_lp * mask).sum(), mask.sum()


def loss_fn(model: W.Whisper, batch: TrainBatch, config: Optional[W.WhisperConfig] = None):
    """Masked next-token cross entropy (``stt_tpu/parallel/trainer.py:
    loss_fn``) on one process."""
    total, count = masked_logprob_sums(model, batch)
    return -total / torch.clamp_min(count, 1.0)


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 0.01):
    """AdamW as ``optax.adamw(learning_rate, weight_decay=weight_decay)``
    sets it: betas 0.9 / 0.999, eps 1e-8, decay on every parameter (optax's
    mask is None). A factory of parameters."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


@contextlib.contextmanager
def _full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, as it was after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@dataclass
class TrainState:
    """One rank's model (its shards of the split parameters), its AdamW and
    the steps taken."""

    model: W.Whisper
    optimizer: torch.optim.Optimizer
    step: int = 0


def _params_dtype(params) -> torch.dtype:
    """float32 or bfloat16: the type of the tree's (or state dict's) leaves."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.bfloat16 if np.asarray(leaf).dtype.name == "bfloat16" else torch.float32


class ShardedTrainer:
    """The train step of one slot of ``mesh``: its rank is the process
    group's, its device the mesh's for that slot. ``optimizer`` is a factory
    of parameters (default :func:`make_optimizer`'s)."""

    def __init__(self, config: W.WhisperConfig, mesh: Mesh, *, optimizer=None,
                 flash_attention: Optional[str] = None) -> None:
        self.config = config
        self.mesh = mesh
        self.optimizer_factory = optimizer or make_optimizer()
        if mesh.size > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"a {mesh.shape} mesh trains over a torch.distributed "
                                   f"group of {mesh.size} processes; none is initialised")
            if dist.get_world_size() != mesh.size:
                raise ValueError(f"mesh {mesh.shape} needs {mesh.size} processes, the "
                                 f"group has {dist.get_world_size()}")
            self.rank = dist.get_rank()
        else:
            self.rank = 0
        self.data_index, self.model_index = mesh.coords(self.rank)
        self.device = mesh.devices[self.rank]
        self.policy = W.AttentionPolicy.from_env(flash_attention=flash_attention)
        # every process creates every group, in one order
        self.model_group = self.data_group = None
        if mesh.model > 1:
            for i in range(mesh.data):
                group = dist.new_group(mesh.model_ranks(i))
                if i == self.data_index:
                    self.model_group = group
        if mesh.data > 1:
            for j in range(mesh.model):
                group = dist.new_group(mesh.data_ranks(j))
                if j == self.model_index:
                    self.data_group = group

    # -- state ------------------------------------------------------------------

    def init_state(self, params: Dict[str, Any], dtype: Optional[torch.dtype] = None
                   ) -> TrainState:
        """This slot's model from a full parameter tree (JAX layout, as
        ``init_params`` gives) or a full state dict, in ``dtype`` (default:
        the leaves' type), its split parameters cut to this slot's shard,
        with a fresh AdamW."""
        dtype = dtype or _params_dtype(params)
        if "encoder" in params and isinstance(params["encoder"], dict):
            model = W.build_model(self.config, params, self.device, dtype, self.policy)
        else:
            with torch.device("meta"):
                model = W.Whisper(self.config, self.policy)
            model.load_state_dict({k: v.detach().to("cpu", torch.float32)
                                   for k, v in params.items()}, strict=True, assign=True)
            model = model.to(device=self.device, dtype=dtype)
        with torch.no_grad():
            for p in model.parameters():
                if p.device.type == "cpu":
                    p.data = p.data.clone()  # not the caller's arrays: AdamW steps in place
        model.requires_grad_(True)
        model.train()
        self.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        shard_model_for_rank(model, self.model_index, self.mesh.model, self.model_group)
        return TrainState(model, self.optimizer_factory(model.parameters()))

    # -- the step ---------------------------------------------------------------

    def local_batch(self, batch: TrainBatch, dtype: torch.dtype) -> TrainBatch:
        """This slot's rows of a global batch, as tensors on its device, the
        mel in ``dtype``."""
        rows = batch_sharding(self.mesh, int(np.shape(batch.mel)[0]), self.data_index)

        def put(x, kind):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            return t[rows].to(self.device, kind)

        return TrainBatch(put(batch.mel, dtype), put(batch.tokens, torch.long),
                          put(batch.loss_mask, torch.float32))

    def value_and_grad(self, state: TrainState, batch: TrainBatch) -> float:
        """The global loss of ``batch``; leaves this slot's gradients (summed
        over the data group) in the parameters' ``.grad``."""
        state.optimizer.zero_grad(set_to_none=True)
        local = self.local_batch(batch, state.model.encoder.pos.dtype)
        with _full_float32():
            total, count = masked_logprob_sums(state.model, local)
            count = count.detach().clone()
            if self.data_group is not None:
                dist.all_reduce(count, group=self.data_group)
            loss = -total / torch.clamp_min(count, 1.0)
            loss.backward()
        loss = loss.detach().clone()
        if self.data_group is not None:
            for p in state.model.parameters():
                dist.all_reduce(p.grad, group=self.data_group)
            dist.all_reduce(loss, group=self.data_group)
        return float(loss)

    def train_step(self, state: TrainState, batch: TrainBatch) -> float:
        """One AdamW step on ``batch``; returns the global loss before it."""
        loss = self.value_and_grad(state, batch)
        state.optimizer.step()
        state.step += 1
        return loss

    # -- full tensors from the shards ---------------------------------------------

    def gather_full(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter ``name`` (or of its gradient or AdamW
        moment) from this slot's shard, all-reduced over the model group from
        zero-filled buffers (exact)."""
        dim = split_dim(name)
        if dim is None or self.mesh.model == 1:
            return tensor.detach().clone()
        shape = self.full_shapes[name]
        lo, hi = split_bounds(shape[dim], self.mesh.model)[self.model_index]
        full = torch.zeros(shape, dtype=tensor.dtype, device=tensor.device)
        full.narrow(dim, lo, hi - lo).copy_(tensor.detach())
        dist.all_reduce(full, group=self.model_group)
        return full

    def full_grads(self, state: TrainState) -> Dict[str, torch.Tensor]:
        return {n: self.gather_full(n, p.grad) for n, p in state.model.named_parameters()}


__all__ = ["ShardedTrainer", "TrainBatch", "TrainState", "loss_fn", "make_optimizer",
           "masked_logprob_sums"]
