"""The port's mesh and split rules against ``stt_tpu/parallel/sharding.py``.

Every parameter's split dimension equals the model axis's place in JAX's
``whisper_param_specs`` for the same leaf after unstacking (the stacked
blocks' leading layer axis dropped); cutting a state dict into shards and
joining them back is the identity, for a model axis that divides the
widths and one that does not; ``build_mesh`` takes shapes and raises as
``tests/test_parallel.py:23-30`` asks of JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from stt_tpu.parallel import sharding as JS
from stt_tpu_torch.convert import from_jax_params
from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.parallel import sharding as S
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)


def _jax_split_dims(params) -> dict:
    """The port's state-dict name -> the model axis's dimension (or None) in
    JAX's spec of the same leaf, unstacked."""
    specs = JS.whisper_param_specs(params)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, JS.P))[0]:
        keys = [k.key for k in path]
        stacked = "blocks" in keys
        dims = list(spec)[1:] if stacked else list(spec)
        dim = dims.index(JS.MODEL_AXIS) if JS.MODEL_AXIS in dims else None
        flat[tuple(keys)] = (dim, stacked)
    out = {}
    for name in from_jax_params(params):
        parts = name.split(".")
        if parts[1] == "blocks":
            key = (parts[0], "blocks", *parts[3:])
        else:
            key = tuple(parts)
        out[name] = flat[key][0]
    return out


@pytest.mark.parametrize("size", ["test", "tiny"])
def test_split_dims_match_jax_specs(size):
    params = W.init_params(W.get_config(size), seed=0)
    state = from_jax_params(params)
    got = S.whisper_param_specs(state)
    ref = _jax_split_dims(params)
    assert got == ref
    split = {n for n, d in got.items() if d is not None}
    assert "decoder.blocks.0.xattn.v.w" in split and "encoder.blocks.1.mlp.fc2.w" in split
    assert "decoder.blocks.0.attn.o.b" not in split and "decoder.tok" not in split


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_shard_then_unshard_is_the_identity(parts):
    """A model axis of 3 does not divide 64 (or 256): the first slices are a
    column longer, as torch.tensor_split cuts them."""
    state = from_jax_params(W.init_params(W.get_config("test"), seed=1))
    mesh = S.build_mesh((1, parts), ["cpu"] * parts)
    shards = [S.shard_params(state, mesh, j) for j in range(parts)]
    w = "encoder.blocks.0.attn.q.w"
    assert [s[w].shape[1] for s in shards] == [
        hi - lo for lo, hi in S.split_bounds(64, parts)]
    joined = S.unshard_params(shards)
    assert joined.keys() == state.keys()
    for name, t in state.items():
        assert torch.equal(joined[name], t), name


def test_split_bounds_are_tensor_split_ranges():
    for n, parts in [(64, 4), (64, 3), (256, 3), (5, 8)]:
        bounds = S.split_bounds(n, parts)
        pieces = torch.tensor_split(torch.arange(n), parts)
        assert [(int(p[0]), int(p[-1]) + 1) if len(p) else None for p in pieces] == [
            (lo, hi) if hi > lo else None for lo, hi in bounds]


def test_build_mesh_shapes_and_errors():
    mesh = S.build_mesh((4, 2), ["cpu"] * 8)
    assert mesh.shape == (4, 2) and (mesh.data, mesh.model, mesh.size) == (4, 2, 8)
    assert mesh.axis_names == (S.DATA_AXIS, S.MODEL_AXIS) == ("data", "model")
    assert mesh.coords(5) == (2, 1) and mesh.model_ranks(1) == [2, 3]
    assert mesh.data_ranks(1) == [1, 3, 5, 7]
    default = S.build_mesh(devices=["cpu"] * 8)
    assert default.shape == (8, 1)
    with pytest.raises(ValueError):
        S.build_mesh((3, 2), ["cpu"] * 8)
    with pytest.raises(ValueError):
        S.build_mesh((0, 8), ["cpu"] * 8)


def test_batch_sharding_splits_rows_over_the_data_axis():
    mesh = S.build_mesh((2, 2), ["cpu"] * 4)
    assert S.batch_sharding(mesh, 6, 1) == slice(3, 6)
    with pytest.raises(ValueError, match="data axis"):
        S.batch_sharding(mesh, 5, 0)


def test_slot_sharded_layers_compute_the_full_layers():
    """In one process over the slots, each split layer (and the MLP) gives
    the full layer's output, on a model axis that does not divide the
    heads' widths."""
    from stt_tpu_torch.parallel.collectives import shard_model_for_slots

    config = W.get_config("test")
    params = W.init_params(config, seed=2)
    full = W.build_model(config, params, torch.device("cpu"))
    split = W.build_model(config, params, torch.device("cpu"))
    shard_model_for_slots(split, [torch.device("cpu")] * 3)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 7, 64)).astype(np.float32))
    for name in ("attn.q", "attn.o", "xattn.k"):
        a = full.decoder.blocks[1].get_submodule(name)
        b = split.decoder.blocks[1].get_submodule(name)
        assert b.w is None and b.shard is not None
        torch.testing.assert_close(b(x), a(x), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(split.encoder.blocks[0].mlp(x), full.encoder.blocks[0].mlp(x),
                               atol=1e-6, rtol=1e-6)
