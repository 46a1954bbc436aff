#!/usr/bin/env python3
"""Prewarm the port's full default shape matrix on one CUDA card and report
what it holds.

    python3 tools/torch_prewarm_matrix.py

Builds a whisper-small ``stt_tpu_torch`` engine in bfloat16 (random weights
from seed 0, the default
attention policy unless ``STT_CROSS_KV_DTYPE`` / ``STT_XATTN_KERNEL`` /
``STT_FLASH_ATTENTION`` say otherwise) with batch buckets 1/4/16/64, then
prewarms every audio bucket (1/2/5/10/30 s) at every batch bucket, one
combination at a time, printing each one's wall time, and after all of them
the decode graphs captured, ``torch.cuda.memory_allocated()`` and
``torch.cuda.memory_reserved()`` and the card's name and power limit. The
last line of stdout is one JSON object with those numbers.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch

    from stt_tpu_torch.bench import card_name_and_power
    from stt_tpu_torch.engine.engine import DEFAULT_AUDIO_BUCKETS_SEC, WhisperEngine

    card = card_name_and_power()
    rows = (1, 4, 16, 64)
    engine = WhisperEngine("small", device="cuda", compute_type="bfloat16", batch_buckets=rows)
    weights = torch.cuda.memory_allocated()
    print(f"card: {card}; engine whisper-small bfloat16, policy "
          f"{engine.policy}; weights {weights / 2**30:.3f} GiB allocated", flush=True)
    seconds = {}
    try:
        for bucket in DEFAULT_AUDIO_BUCKETS_SEC:
            for n in rows:
                seconds[f"{bucket:g}s x{n}"] = engine.prewarm([bucket], [n])
                print(f"prewarm {bucket:g} s x {n} rows: {seconds[f'{bucket:g}s x{n}']:.3f} s",
                      flush=True)
        torch.cuda.synchronize()
        result = {
            "card": card, "model": "small", "compute_type": "bfloat16",
            "policy": str(engine.policy), "combinations": len(seconds),
            "graph_captures": engine.graph_captures,
            "prewarm_s": sum(seconds.values()),
            "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "memory_reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "weights_gib": weights / 2**30,
        }
    finally:
        engine.close()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
