"""Multi-slot dry run of the port: training and serving on a (data, model)
mesh, and the process launcher the trainer's ranks run under.

    python -m stt_tpu_torch.parallel.dryrun [--slots 8] [--device cpu|cuda]

Counterpart of ``__graft_entry__.py::dryrun_multichip``: the same four
proofs on the "tiny" config at a mesh of (slots // 2, 2), each run for
real at tiny shapes:

1. training: one sharded train step in ``slots`` gloo processes, its loss
   finite and equal to one process's;
2. serving: a mesh engine's transcript identical to a single engine's on
   the same audio;
3. a drafted partial under the mesh, twice, identical too;
4. registry-routed serving through the fair queue: two sessions' partials
   and finals on a registry whose engines default to ``mesh_shape`` (as
   the runtime passes ``--tpu-mesh-shape``), every transcript equal to the
   single engine's on the same wire bytes.

On the CPU every slot is ``cpu``; with ``--device cuda`` the slots take
the visible cards in turn (slot i on ``cuda:{i % cards}``; on one card
every slot is ``cuda:0``, and two gloo ranks may share it: the trainer's
collectives are all-reduces, which gloo carries for CUDA tensors). Slots
on several cards run the mesh engine's decode uncaptured.

:func:`spawn` runs a function in one process per rank under a
``torch.distributed`` gloo group that rendezvous through a file, with a
deadline: a rank that fails or hangs fails the whole call in seconds, and
every process is stopped before it returns or raises.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


def _rank_main(fn: Callable, rank: int, world: int, init_file: str, timeout: float,
               args: Sequence[Any], results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *, workdir: str = None,
          timeout: float = 120.0) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` new processes joined in one
    gloo group; returns each rank's result, in rank order. ``fn`` must be
    importable (a module-level function). Raises with the first failing
    rank's traceback, or when ``timeout`` seconds pass; all processes are
    stopped either way."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init_file, timeout, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out: dict = {}
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks did not finish "
                                       f"within {timeout:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
    return [out[r] for r in range(world)]


def tiny_batch(config, rows: int, seed: int = 0, frames: int = 100, tokens: int = 12):
    """The dry run's batch: random mel, random token ids under 1000, a mask
    of ones (``__graft_entry__.py:84-91``)."""
    from .trainer import TrainBatch

    rng = np.random.default_rng(seed)
    return TrainBatch(rng.normal(0, 1, (rows, config.n_mels, frames)).astype(np.float32),
                      rng.integers(0, 1000, (rows, tokens)).astype(np.int64),
                      np.ones((rows, tokens), np.float32))


def _train_rank(rank: int, world: int, shape, devices, size: str, rows: int):
    """One train step of the dry run on this rank; returns its loss."""
    from ..models import whisper as W
    from .sharding import build_mesh
    from .trainer import ShardedTrainer

    config = W.get_config(size)
    trainer = ShardedTrainer(config, build_mesh(shape, devices))
    state = trainer.init_state(W.init_params(config, seed=0))
    return trainer.train_step(state, tiny_batch(config, rows))


def grads_rank(rank: int, world: int, shape, devices, size: str, params_seed: int, batch,
               flash: str = "off", steps: int = 1, out_path: Optional[str] = None):
    """A sharded trainer's first step on this rank: its global loss and the
    full gradients (gathered over the model group), then ``steps - 1`` more
    steps. Returns (losses, gradients, seconds of each step's loss and
    gradients): rank 0's gradients as numpy or, with ``out_path``, written
    there (``torch.save``) and returned as None; the other ranks' None."""
    import torch

    from ..models import whisper as W
    from .sharding import build_mesh
    from .trainer import ShardedTrainer, TrainBatch

    config = W.get_config(size)
    trainer = ShardedTrainer(config, build_mesh(shape, devices), flash_attention=flash)
    state = trainer.init_state(W.init_params(config, seed=params_seed))
    batch = TrainBatch(*batch)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    losses, seconds = [], []
    for step in range(steps):
        sync()
        t0 = time.perf_counter()
        losses.append(trainer.value_and_grad(state, batch))
        sync()
        seconds.append(time.perf_counter() - t0)
        if step == 0:
            grads = trainer.full_grads(state)
        state.optimizer.step()
        state.step += 1
    if rank != 0:
        return losses, None, seconds
    if out_path is not None:
        torch.save({n: g.cpu() for n, g in grads.items()}, out_path)
        return losses, None, seconds
    return losses, {n: g.float().cpu().numpy() for n, g in grads.items()}, seconds


def restore_rank(rank: int, world: int, shape, devices, size: str, path: str, batch,
                 flash: str = "off"):
    """Restore the checkpoint ``path`` on this rank's slot of a ``shape``
    mesh and take one step; returns (the restored step count, the step's
    loss)."""
    from ..models import whisper as W
    from .checkpoint import restore_checkpoint
    from .sharding import build_mesh
    from .trainer import ShardedTrainer, TrainBatch

    trainer = ShardedTrainer(W.get_config(size), build_mesh(shape, devices),
                             flash_attention=flash)
    state = restore_checkpoint(path, trainer)
    return state.step, trainer.train_step(state, TrainBatch(*batch))


def _text(out) -> str:
    return " ".join(s.text for s in out.segments)


def _proof_audio() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.asarray(0.1 * rng.normal(0, 1, 16000), np.float32)


def train_proof(shape, devices, size: str = "tiny") -> float:
    """Proof 1: one sharded train step in one gloo process a slot (rank i on
    ``devices[i]``), every rank's loss finite and within 1e-4 of one
    process's on ``devices[0]``. Returns it."""
    from ..models import whisper as W
    from .sharding import build_mesh
    from .trainer import ShardedTrainer

    world = shape[0] * shape[1]
    rows = max(2, shape[0])
    losses = spawn(_train_rank, world, (shape, list(devices), size, rows), timeout=300.0)
    config = W.get_config(size)
    single = ShardedTrainer(config, build_mesh((1, 1), devices[:1]))
    ref = single.train_step(single.init_state(W.init_params(config, seed=0)),
                            tiny_batch(config, rows))
    if not all(np.isfinite(losses)) or max(abs(x - ref) for x in losses) > 1e-4 * abs(ref):
        raise AssertionError(f"sharded train step: losses {losses}, one process {ref}")
    print(f"dryrun train step ok: loss={losses[0]:.4f} mesh={shape} "
          f"(one process {ref:.4f})", flush=True)
    return losses[0]


def serving_proofs(shape, devices) -> None:
    """Proofs 2 and 3: the "test" model in float32 on a ``shape`` mesh over
    ``devices``, its transcript (and two drafted partials') identical to a
    single engine's on ``devices[0]``."""
    from ..engine.engine import DecodeRequest, WhisperEngine

    audio = _proof_audio()

    def req(**kw):
        return DecodeRequest(audio=audio, language="en", **kw)

    one = WhisperEngine("test", device=devices[0], compute_type="float32")
    out_single = one.transcribe_sync(req())
    one.close()
    sharded = WhisperEngine("test", device=devices[0], compute_type="float32",
                            mesh_shape=shape, mesh_devices=list(devices), draft_mode="on")
    try:
        out_sharded = sharded.transcribe_sync(req())
        if _text(out_sharded) != _text(out_single) or \
                abs(out_sharded.avg_logprob - out_single.avg_logprob) > 1e-2:
            raise AssertionError(f"sharded serving diverged: {_text(out_single)!r} vs "
                                 f"{_text(out_sharded)!r}")
        print(f"dryrun sharded serving ok: transcript identical on the {shape} mesh "
              f"({len(out_single.segments)} segments)", flush=True)
        partials = [sharded.transcribe_sync(req(is_final=False, session_id="dryrun-s"))
                    for _ in range(2)]
        if any(_text(p) != _text(out_single) for p in partials):
            raise AssertionError("drafted partial diverged under the mesh")
        accepted = sharded.draft_stats["accepted"]
    finally:
        sharded.close()
    print(f"dryrun drafted partial ok: transcript identical, {accepted} draft tokens "
          f"accepted on the mesh", flush=True)


def registry_proof(shape, devices) -> int:
    """Proof 4: two sessions' partials and finals through the fair queue of
    a registry whose engines default to ``mesh_shape``, every transcript
    equal to a single engine's on the same wire bytes. Returns the decodes
    checked."""
    from concurrent.futures import CancelledError

    from ..engine.engine import DecodeRequest, WhisperEngine
    from ..engine.registry import ModelRegistry, _prepare_audio

    audio = _proof_audio()
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16).tobytes()
    ref_engine = WhisperEngine("test", device=devices[0], compute_type="float32")
    ref_text = _text(ref_engine.transcribe_sync(
        DecodeRequest(audio=_prepare_audio(pcm, 16000), language="en")))
    ref_engine.close()
    registry = ModelRegistry(engine_defaults={
        "mesh_shape": shape, "mesh_devices": list(devices)})
    registry.load_model("default", {
        "backend": "torch_whisper", "model_size": "test", "device": str(devices[0]),
        "compute_type": "float32", "batch_window_ms": 1.0, "prewarm": False,
    })
    try:
        futs = [(sess, final, registry.submit_decode("default", sess, pcm, 16000,
                                                     {"language": "en"}, is_final=final))
                for final in (False, True) for sess in ("dryrun-a", "dryrun-b")]
        n_ok = 0
        for sess, final, fut in futs:
            try:
                res = fut.result(timeout=300)
            except CancelledError:
                if final:  # a final may cancel its session's queued partial, not itself
                    raise
                continue
            if _text(res) != ref_text:
                raise AssertionError(f"registry-routed transcript diverged ({sess}, "
                                     f"final={final}): {ref_text!r} vs {_text(res)!r}")
            n_ok += 1
        if n_ok < 2:
            raise AssertionError("both finals must complete")
    finally:
        registry.close(drain_timeout_sec=30.0)
    print(f"dryrun registry-routed serving ok: {n_ok} decodes transcript-identical "
          f"through the fair queue on the {shape} mesh", flush=True)
    return n_ok


def slot_devices(slots: int, device: str = "cpu") -> List[str]:
    """The dry run's slots: ``cpu`` each, or the visible cards in turn."""
    if device == "cpu":
        return ["cpu"] * slots
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("--device cuda needs a CUDA card")
    return [f"cuda:{i % cards}" for i in range(slots)]


def dryrun(slots: int = 8, device: str = "cpu", size: str = "tiny") -> None:
    """The four proofs at (slots // 2, 2), printed as they pass; raises on
    the first that fails."""
    model_par = 2 if slots % 2 == 0 and slots >= 2 else 1
    shape = (slots // model_par, model_par)
    devices = slot_devices(slots, device)
    print(f"dryrun slots: {devices}", flush=True)
    train_proof(shape, devices, size)
    serving_proofs(shape, devices)
    registry_proof(shape, devices)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="cpu slots, or the visible cards in turn")
    args = ap.parse_args(argv)
    dryrun(args.slots, args.device)


if __name__ == "__main__":
    main()
