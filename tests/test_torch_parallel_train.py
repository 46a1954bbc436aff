"""The sharded train step over gloo processes against one process.

Each case runs ``stt_tpu_torch.parallel.dryrun.grads_rank`` in one process
per slot of a (data, model) mesh on the "test" config (2 heads of 32, so a
model axis of 4 splits inside a head, as JAX's own (2, 4) test does), the
ranks meeting through a file under ``tmp_path`` with a deadline. Rank 0
returns the global loss and the full gradients (gathered over the model
group); both must equal one process's within 1e-5 (relative; float32 sums
in another order). The batch's masks differ between the data ranks' rows,
which a per-rank mean (DDP's) gets wrong. The (2, 4) loss is also held
against JAX's loss on parameters sharded over a (2, 4) mesh
(``tests/test_parallel.py:51-66``). ``parallel/dryrun.py`` runs its four
proofs at 8 slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu.parallel import sharding as JS
from stt_tpu.parallel import trainer as JT
from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.parallel import dryrun
from stt_tpu_torch.parallel import trainer as T
from stt_tpu_torch.parallel.sharding import build_mesh
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CONFIG = W.get_config("test")
SEED = 3
DEADLINE = 120.0


def _batch(rows: int = 4):
    rng = np.random.default_rng(SEED)
    mask = np.ones((rows, 10), np.float32)
    mask[1, 4:] = 0.0
    mask[rows - 1, 2:] = 0.0  # the last data rank's rows hold fewer labels
    return T.TrainBatch(rng.normal(0, 1, (rows, CONFIG.n_mels, 100)).astype(np.float32),
                        rng.integers(0, 1000, (rows, 10)).astype(np.int64), mask)


def _single(batch, steps: int = 1):
    trainer = T.ShardedTrainer(CONFIG, build_mesh((1, 1), ["cpu"]))
    state = trainer.init_state(W.init_params(CONFIG, seed=SEED))
    loss = trainer.value_and_grad(state, batch)
    grads = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()}
    state.optimizer.step()
    losses = [loss] + [trainer.train_step(state, batch) for _ in range(steps - 1)]
    return losses, grads


def _run(shape, batch, tmp_path, steps: int = 1):
    world = shape[0] * shape[1]
    results = dryrun.spawn(dryrun.grads_rank, world,
                           (shape, ["cpu"] * world, "test", SEED, tuple(batch), "off", steps),
                           workdir=str(tmp_path), timeout=DEADLINE)
    losses = [r[0] for r in results]
    assert all(np.allclose(x, losses[0], rtol=1e-6) for x in losses)
    return losses[0], results[0][1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (2, 4)])
def test_mesh_loss_and_every_gradient_equal_one_process(shape, tmp_path):
    batch = _batch()
    ref_losses, ref_grads = _single(batch, steps=2)
    losses, grads = _run(shape, batch, tmp_path, steps=2)
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= 1e-5 * abs(ref), (losses, ref_losses)
    assert grads.keys() == ref_grads.keys()
    for name, ref in ref_grads.items():
        assert grads[name].shape == ref.shape, name
        err = np.abs(grads[name] - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < 1e-5, (name, err)
    if shape == (2, 4):
        # JAX's loss on the same weights sharded over its (2, 4) mesh
        params = jax.tree.map(jnp.asarray, W.init_params(CONFIG, seed=SEED))
        sharded = JS.shard_params(params, JS.build_mesh((2, 4)))
        jax_loss = float(JT.loss_fn(sharded, JT.TrainBatch(*(jnp.asarray(x) for x in batch)),
                                    JW.get_config("test")))
        assert abs(losses[0] - jax_loss) <= 1e-5 * abs(jax_loss)


def test_uneven_masks_need_the_global_count(tmp_path):
    """At (2, 1) the two data ranks hold 14 and 10 labels: the mesh's loss
    is the global masked mean, which the mean of the two ranks' means (what
    averaging each rank's loss gives) misses by more than ten times the
    bar (random weights make every token's log-prob close, so the gap is
    small, but it is there)."""
    batch = _batch()
    model = W.build_model(CONFIG, W.init_params(CONFIG, seed=SEED), torch.device("cpu"))
    parts = [T.masked_logprob_sums(model, T.TrainBatch(*(torch.as_tensor(x[rows])
                                                           for x in batch)))
             for rows in (slice(0, 2), slice(2, 4))]
    assert float(parts[0][1]) != float(parts[1][1])
    ddp_mean = float(sum(-t / n for t, n in parts) / 2)
    (loss,), _ = _run((2, 1), batch, tmp_path)
    ref, _ = _single(batch)
    assert abs(loss - ref[0]) <= 1e-5 * abs(ref[0])
    assert abs(ddp_mean - ref[0]) > 10 * 1e-5 * abs(ref[0])


def test_dryrun_four_proofs_at_8_slots(capsys):
    dryrun.dryrun(8, "cpu")
    out = capsys.readouterr().out
    for proof in ("train step ok", "sharded serving ok", "drafted partial ok",
                  "registry-routed serving ok"):
        assert f"dryrun {proof}" in out
