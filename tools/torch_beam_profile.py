#!/usr/bin/env python3
"""Where a captured decode step's device time goes, greedy against beam 5.

    python3 tools/torch_beam_profile.py

Builds a whisper-small ``stt_tpu_torch`` engine in bfloat16 on the card
(random weights from seed 0, the default attention policy: int8 cross K/V,
einsum attention), prewarms the 10 s bucket at 4 and 64 rows at beams 1 and
5, then for each (rows, beam) replays the entry's captured chunk of 8 steps
4 times under ``torch.profiler`` (the position reset to
the prompt's end first, as ``stt_tpu_torch.bench.decode_step_ms`` does) and
prints, per decode step, the device time by kind
(``stt_tpu_torch.bench.kind_of``) and the top device operations, beside the
card's name and power limit. The last line of stdout is one JSON object
with the per-step device ms by kind for every (rows, beam).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROWS = (4, 64)
CHUNKS = 4  # replays profiled per (rows, beam)
TOP = 12    # device operations printed per (rows, beam)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch import bench as B
    from stt_tpu_torch.engine.engine import WhisperEngine
    from stt_tpu_torch.models import whisper as W

    card = B.card_name_and_power()
    engine = WhisperEngine("small", device="cuda", compute_type="bfloat16",
                           batch_buckets=(1, *ROWS))
    bucket = 10.0
    max_new = engine._max_new_for(bucket)
    engine.prewarm([bucket], ROWS, beam_sizes=[1, 5])
    result = {"card": card, "bucket_sec": bucket, "per_step_ms": {}}
    try:
        for rows in ROWS:
            for beam in (1, 5):
                entry = engine.graphs.lookup(bucket, rows, B.PROMPT_LEN, max_new, beam)
                st = entry.state
                st.pos.fill_(B.PROMPT_LEN)
                st.finished.zero_()
                entry.graph.replay()  # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(CHUNKS):
                        st.pos.fill_(B.PROMPT_LEN)
                        entry.graph.replay()
                    torch.cuda.synchronize()
                steps = CHUNKS * W.FINISH_CHECK_EVERY
                totals = {}
                for e in prof.events():
                    if e.device_type != torch.autograd.DeviceType.CUDA:
                        continue
                    t = totals.setdefault(e.name, [0, 0.0])
                    t[0] += 1
                    t[1] += e.time_range.end - e.time_range.start
                kinds = {}
                for name, (_, us) in totals.items():
                    kinds[B.kind_of(name)] = kinds.get(B.kind_of(name), 0.0) + us
                per_step = {k: us / steps / 1e3 for k, us in kinds.items()}
                tag = f"{rows} x {bucket:g} s, beam {beam}"
                result["per_step_ms"][tag] = per_step
                print(f"{tag}: {sum(per_step.values()):.4f} ms of device time a step "
                      f"({sum(c for c, _ in totals.values()) / steps:.1f} operations); "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  sorted(per_step.items(), key=lambda kv: -kv[1]))
                      + f" ({card})", flush=True)
                for name, (count, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[
                        :TOP]:
                    print(f"  {us / steps / 1e3:8.4f} ms a step  x{count / steps:<5.1f} "
                          f"{us / count:8.2f} us each  {name[:120]}", flush=True)
    finally:
        engine.close()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
