#!/usr/bin/env python3
"""Train and serve whisper-small over a mesh whose slots are separate cards.

    python3 tools/torch_mesh_cards.py [--shape 2x2] [--serve-shape 1x4]

Needs as many CUDA cards as the larger mesh has slots, and nvcc. Slot i is
``cuda:i``. Two comparisons, each against one card in the same call:

1. training: ``stt_tpu_torch.parallel.trainer`` on whisper-small float32,
   flash on, with ``chip_smoke.py`` phase 3k's batch (4 rows of a 30 s mel,
   128 random tokens a row): one gloo process a slot of ``--shape``, two
   steps, against one process on ``cuda:0``: the losses within 1e-5
   (relative) and the first step's full gradients within 1e-4 of each
   leaf's largest |gradient| (the bars of phase 3k); seconds a step (loss
   and gradients) on each side;
2. serving: the engine at ``--serve-shape`` over ``cuda:0..`` (slots on
   several cards: the decode chunks run uncaptured), whisper-small bf16 on
   the default attention path at 64 x 10 s, against one card's engine: the
   token agreement, and ms per decode step uncaptured on both and
   captured on the one card (``stt_tpu_torch.bench.decode_step_ms``).

Prints the card's name and power limit, a line a comparison and one JSON
line last. ``--device cpu --size test`` rehearses it on the host (CPU
slots, the "test" model, no timing of decode steps).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _shape(text: str):
    data, model = (int(x) for x in text.lower().split("x"))
    return data, model


def train_compare(C, W, T, dryrun, shape, devices, size: str, workdir: str) -> dict:
    batch = tuple(C.train_batch(W, T))
    out = {}
    for tag, mesh, slots in (("one", (1, 1), devices[:1]), ("mesh", shape, devices)):
        path = str(Path(workdir) / f"grads-{tag}.pt")
        t0 = time.monotonic()
        results = dryrun.spawn(dryrun.grads_rank, len(slots),
                               (mesh, slots, size, 0, batch, "auto", 2, path),
                               workdir=workdir, timeout=600.0)
        losses, _, seconds = results[0]
        import torch

        out[tag] = {"losses": losses, "seconds": seconds, "wall": time.monotonic() - t0,
                    "grads": torch.load(path, weights_only=True)}
    err = C.grad_errors(out["mesh"]["grads"], out["one"]["grads"])
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(out["mesh"]["losses"],
                                                      out["one"]["losses"])]
    line = (f"train {shape} over {devices}: losses {out['mesh']['losses']} against "
            f"{out['one']['losses']} (relative {[f'{e:.3g}' for e in loss_errs]}), gradients "
            f"{err:.3g} of each leaf's largest |gradient|; seconds a step "
            f"{[round(x, 3) for x in out['mesh']['seconds']]} against "
            f"{[round(x, 3) for x in out['one']['seconds']]} on one card")
    print(line, flush=True)
    if max(loss_errs) > LOSS_REL or err > GRAD_REL:
        sys.exit(f"FAIL: {line}")
    return {"loss_rel": max(loss_errs), "grad_rel": err,
            "mesh_s": out["mesh"]["seconds"], "one_s": out["one"]["seconds"]}


def serve_compare(C, E, W, shape, devices, size: str, device: str) -> dict:
    from stt_tpu_torch import bench as B

    tokens, ms = {}, {}
    timed = device != "cpu"
    for tag, kw in (("one", {}), ("mesh", dict(mesh_shape=shape, mesh_devices=devices))):
        eng = E.WhisperEngine(size, device=devices[0], compute_type="bfloat16",
                              batch_buckets=(64,), cross_kv_dtype="int8",
                              xattn_kernel="off", flash_attention="off", draft_mode="off",
                              **kw)
        try:
            outs = eng._harvest(eng._device_phase(C.group_tasks(E, 10.0, 64, 90)))
            tokens[tag] = np.stack([o._tokens for o in outs])
            if timed:
                ms[tag] = {c: B.decode_step_ms(eng, 10.0, 64, captured=c)
                           for c in ((False, True) if tag == "one" else (False,))}
        finally:
            eng.close()
    agree = float((tokens["mesh"] == tokens["one"]).mean())
    line = f"serve {shape} over {devices}: token agreement {agree:.3f} with one card"
    if timed:
        line += (f"; ms a decode step at 64 x 10 s: mesh uncaptured "
                 f"{ms['mesh'][False]:.4f}, one card uncaptured {ms['one'][False]:.4f}, "
                 f"captured {ms['one'][True]:.4f}")
    print(line, flush=True)
    return {"agreement": agree,
            "ms": {k: {str(c): v for c, v in d.items()} for k, d in ms.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=_shape, default=(2, 2))
    ap.add_argument("--serve-shape", type=_shape, default=(1, 4))
    ap.add_argument("--size", default="small")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as C  # phase 3k's batch, the gradient check, the card's name
    from stt_tpu_torch.engine import engine as E
    from stt_tpu_torch.models import whisper as W
    from stt_tpu_torch.parallel import dryrun
    from stt_tpu_torch.parallel import trainer as T

    slots = max(args.shape[0] * args.shape[1], args.serve_shape[0] * args.serve_shape[1])
    if args.device == "cuda":
        if torch.cuda.device_count() < slots:
            sys.exit(f"needs {slots} CUDA cards, found {torch.cuda.device_count()}")
        print(C.gpu_name_and_power(), flush=True)
        from stt_tpu_torch.ops.cuda import build

        build.load_many(C.KERNELS)  # once here, so the ranks only load the objects
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        devices = [f"cuda:{i}" for i in range(slots)]
    else:
        C.TRAIN_ROWS, C.TRAIN_TOKENS = 2, 16
        devices = ["cpu"] * slots
    n_train = args.shape[0] * args.shape[1]
    with tempfile.TemporaryDirectory(dir=ROOT) as workdir:
        train = train_compare(C, W, T, dryrun, args.shape, devices[:n_train], args.size,
                              workdir)
    n_serve = args.serve_shape[0] * args.serve_shape[1]
    serve = serve_compare(C, E, W, args.serve_shape, devices[:n_serve], args.size,
                          args.device)
    print(json.dumps({"train": train, "serve": serve}), flush=True)


if __name__ == "__main__":
    main()
