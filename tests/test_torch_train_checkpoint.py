"""The trainer's checkpoint: save, restore, resume, on one mesh and another.

``stt_tpu_torch.parallel.checkpoint.save_checkpoint`` writes the full
parameters and AdamW state gathered from the shards; ``restore_checkpoint``
cuts them for the restoring trainer's mesh (orbax's restore into the
template's shardings, ``stt_tpu/parallel/checkpoint.py:34``). On the
"test" config: the round trip gives back every parameter and moment
bitwise; a run resumed after two steps takes a third step whose loss is
bitwise the uninterrupted run's; a checkpoint written at (1, 1) restores
on a (1, 2) mesh of gloo processes (and one written there restores on one
process), the next loss within 1e-5.
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.parallel import dryrun
from stt_tpu_torch.parallel import trainer as T
from stt_tpu_torch.parallel.checkpoint import restore_checkpoint, save_checkpoint
from stt_tpu_torch.parallel.sharding import build_mesh
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CONFIG = W.get_config("test")


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 10), np.float32)
    mask[0, 6:] = 0.0
    return T.TrainBatch(rng.normal(0, 1, (2, CONFIG.n_mels, 100)).astype(np.float32),
                        rng.integers(0, 1000, (2, 10)).astype(np.int64), mask)


def _trainer():
    return T.ShardedTrainer(CONFIG, build_mesh((1, 1), ["cpu"]))


def _two_steps(trainer):
    state = trainer.init_state(W.init_params(CONFIG, seed=4))
    for _ in range(2):
        trainer.train_step(state, _batch())
    return state


def test_round_trip_gives_back_every_parameter_and_moment(tmp_path):
    trainer = _trainer()
    state = _two_steps(trainer)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, trainer, state)
    restored = restore_checkpoint(path, _trainer())
    assert restored.step == 2
    params = dict(restored.model.named_parameters())
    for name, p in state.model.named_parameters():
        assert torch.equal(params[name], p), name
        mine, theirs = state.optimizer.state[p], restored.optimizer.state[params[name]]
        assert mine.keys() == theirs.keys()
        for key in mine:
            assert torch.equal(mine[key], theirs[key]), (name, key)


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    trainer = _trainer()
    state = _two_steps(trainer)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, trainer, state)
    third = trainer.train_step(state, _batch())
    fourth = trainer.train_step(state, _batch())
    again = _trainer()
    resumed = restore_checkpoint(path, again)
    assert again.train_step(resumed, _batch()) == third
    assert again.train_step(resumed, _batch()) == fourth
    assert resumed.step == state.step == 4


@pytest.mark.parametrize("direction", ["one_to_mesh", "mesh_to_one"])
def test_restore_under_another_mesh(tmp_path, direction):
    path = str(tmp_path / "ckpt.pt")
    batch = tuple(_batch())
    if direction == "one_to_mesh":
        trainer = _trainer()
        state = _two_steps(trainer)
        save_checkpoint(path, trainer, state)
        ref = trainer.train_step(state, _batch())
        results = dryrun.spawn(dryrun.restore_rank, 2,
                               ((1, 2), ["cpu"] * 2, "test", path, batch),
                               workdir=str(tmp_path), timeout=120.0)
        for step, loss in results:
            assert step == 2 and abs(loss - ref) <= 1e-5 * abs(ref)
    else:
        results = dryrun.spawn(_save_after_two_steps, 2, (path, batch),
                               workdir=str(tmp_path), timeout=120.0)
        step, loss = _restore_one(path)
        assert step == 2 and abs(loss - results[0]) <= 1e-5 * abs(results[0])


def _save_after_two_steps(rank, world, path, batch):
    """(Runs in a spawned rank.) Two steps at (1, 2), a checkpoint, then the
    third step's loss."""
    trainer = T.ShardedTrainer(CONFIG, build_mesh((1, 2), ["cpu"] * 2))
    state = trainer.init_state(W.init_params(CONFIG, seed=4))
    for _ in range(2):
        trainer.train_step(state, T.TrainBatch(*batch))
    save_checkpoint(path, trainer, state)
    return trainer.train_step(state, T.TrainBatch(*batch))


def _restore_one(path):
    trainer = _trainer()
    state = restore_checkpoint(path, trainer)
    return state.step, trainer.train_step(state, _batch())
