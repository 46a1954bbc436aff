"""The port's train step on one process against the JAX package's.

``stt_tpu_torch.parallel.trainer`` on the "test" config, from the same
``init_params`` tree as ``stt_tpu.parallel.trainer``: the loss within 1e-5
(relative), every leaf's gradient within 1e-5 of the leaf's largest
|gradient| (both float32; sums in another order), one AdamW step within
1e-7 of one ``optax.adamw`` step, four steps falling, and flash attention
at 512 positions or more (the autograd Function, plain on the CPU) giving
flash off's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu.parallel import trainer as JT
from stt_tpu_torch.convert import to_jax_params
from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.parallel import trainer as T
from stt_tpu_torch.parallel.sharding import build_mesh
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CONFIG = W.get_config("test")


def _batch(seed: int, rows: int = 4, frames: int = 100, tokens: int = 10):
    rng = np.random.default_rng(seed)
    mask = np.ones((rows, tokens), np.float32)
    mask[1, tokens // 2:] = 0.0  # rows of unequal length
    return T.TrainBatch(rng.normal(0, 1, (rows, CONFIG.n_mels, frames)).astype(np.float32),
                        rng.integers(0, 1000, (rows, tokens)).astype(np.int32), mask)


def _jax(batch: T.TrainBatch):
    return JT.TrainBatch(*(jnp.asarray(x) for x in batch))


def _trainer(**kw) -> T.ShardedTrainer:
    return T.ShardedTrainer(CONFIG, build_mesh((1, 1), ["cpu"]), **kw)


def _leaf_errors(got_tree, ref_tree) -> dict:
    """The largest |got - ref| of each leaf over the leaf's largest |ref|."""
    out = {}
    for (path, ref), got in zip(jax.tree_util.tree_flatten_with_path(ref_tree)[0],
                                jax.tree_util.tree_leaves(got_tree)):
        ref = np.asarray(ref, np.float32)
        scale = max(float(np.abs(ref).max()), 1e-30)
        out[jax.tree_util.keystr(path)] = float(np.abs(np.asarray(got) - ref).max()) / scale
    return out


def test_loss_and_every_gradient_match_jax():
    params = W.init_params(CONFIG, seed=7)
    batch = _batch(7)
    ref_loss, ref_grads = jax.value_and_grad(JT.loss_fn)(
        jax.tree.map(jnp.asarray, params), _jax(batch), JW.get_config("test"))
    trainer = _trainer()
    state = trainer.init_state(params)
    loss = trainer.value_and_grad(state, batch)
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    grads = to_jax_params({n: p.grad for n, p in state.model.named_parameters()})
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(ref_grads)
    errors = _leaf_errors(grads, ref_grads)
    assert max(errors.values()) < 1e-5, max(errors.items(), key=lambda kv: kv[1])


def test_loss_fn_matches_jax_loss_fn():
    params = W.init_params(CONFIG, seed=3)
    batch = _batch(3)
    ref = float(JT.loss_fn(jax.tree.map(jnp.asarray, params), _jax(batch),
                           JW.get_config("test")))
    model = W.build_model(CONFIG, params, torch.device("cpu"))
    got = float(T.loss_fn(model, T.TrainBatch(*(torch.as_tensor(x) for x in batch))))
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_one_adamw_step_matches_optax():
    params = W.init_params(CONFIG, seed=11)
    batch = _batch(11)
    jparams = jax.tree.map(jnp.array, params)
    grads = jax.grad(JT.loss_fn)(jparams, _jax(batch), JW.get_config("test"))
    opt = JT.make_optimizer()
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    ref = optax.apply_updates(jparams, updates)
    trainer = _trainer()
    state = trainer.init_state(params)
    trainer.train_step(state, batch)
    got = to_jax_params(state.model.state_dict())
    # the first step moves each parameter by ~lr (1e-5) along the sign of its
    # gradient, so a near-zero gradient may flip its sign: the gradients
    # are held above; here every moved value must agree within 1e-7, or
    # within one float32 step of the value where that step is larger (1.19e-7
    # just above 1: the two updates order their operations differently),
    # where the gradient is not tiny
    worst = 0.0
    for (path, r), g, gr in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(grads)):
        gr, r = np.asarray(gr), np.asarray(r)
        stable = np.abs(gr) > 1e-4 * max(float(np.abs(gr).max()), 1e-30)
        allowed = np.maximum(1e-7, np.spacing(np.abs(r)))
        excess = np.abs(np.asarray(g) - r) / allowed
        worst = max(worst, float(excess[stable].max()) if stable.any() else 0.0)
    assert worst <= 1.0, worst


def test_four_steps_fall():
    trainer = _trainer()
    state = trainer.init_state(W.init_params(CONFIG, seed=1))
    batch = _batch(1)
    losses = [trainer.train_step(state, batch) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 4


def test_flash_on_at_512_positions_gives_flash_off_gradients():
    """1100 mel frames: 550 encoder positions reach FLASH_MIN_SEQ, so with
    flash on every encoder layer goes through the autograd Function."""
    params = W.init_params(CONFIG, seed=5)
    batch = _batch(5, rows=2, frames=1100)
    out = {}
    for flash in ("off", "auto"):
        trainer = _trainer(flash_attention=flash)
        state = trainer.init_state(params)
        out[flash] = (trainer.value_and_grad(state, batch),
                      {n: p.grad.clone() for n, p in state.model.named_parameters()})
    assert abs(out["auto"][0] - out["off"][0]) <= 1e-6 * abs(out["off"][0])
    for name, ref in out["off"][1].items():
        err = (out["auto"][1][name] - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
        assert err < 1e-5, (name, float(err))


def test_bf16_parameters_train_in_bf16():
    tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                        W.init_params(CONFIG, seed=2))
    trainer = _trainer()
    state = trainer.init_state(tree)
    assert {p.dtype for p in state.model.parameters()} == {torch.bfloat16}
    loss = trainer.train_step(state, _batch(2))
    assert np.isfinite(loss)


def test_a_mesh_of_several_slots_needs_its_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        T.ShardedTrainer(CONFIG, build_mesh((2, 1), ["cpu"] * 2))
