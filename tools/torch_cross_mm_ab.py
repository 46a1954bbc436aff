#!/usr/bin/env python3
"""Time the cross-attention of int8 K/V at one decode position, and one
checkout's decode steps, on the card.

    python3 tools/torch_cross_mm_ab.py --kernels [--heads H] [--rows 1,4,16,64]
    python3 tools/torch_cross_mm_ab.py --steps --tree DIR [--tag NAME] [--model NAME]
        [--rows 1,4,16,64]

``--kernels`` (this checkout) holds the two int8-code products
(``stt_tpu_torch/ops/kernels/cross_mm.py``) against their plain versions
at H heads (12, whisper-small's, unless ``--heads`` says otherwise; 20 is
large-v3-turbo's) x Dh 64, each of ``--rows`` x 50/250/1500 keys,
and times with this repository's cold timer (``chip_smoke.cuda_ms_cold``:
L2 flushed, the device spinning until the call is enqueued) each launch
alone, the pair with torch's softmax between them as the decode step runs
it, the plain pair, and the widening route (``_attn_cached``: the codes
widened to bf16, cuBLAS's products, the softmax and its rounding), each
launch beside its bound (bytes over 3.35 TB/s, or float32 operations over
67 TFLOP/s, whichever is larger). The pair and the widening route are also
timed as 24 calls captured in one CUDA graph (warm L2, no host time between
launches), as a captured decode step meets a small cross K/V; over 250 and
1500 keys each launch is also timed at every split it takes.

``--steps`` imports ``stt_tpu_torch`` from DIR (a checkout, for example
the parent commit unpacked with ``git archive``) and times one captured
chunk of ``FINISH_CHECK_EVERY`` decode steps of ``--model`` (whisper-small
unless it says otherwise; bf16, int8 cross K/V, attention kernels off: the
shipped deployment) for each decode mode's graph, greedy, drafted resume
and beam 5, at each of ``--rows`` (batch buckets) over the 5 s and 30 s
buckets (CUDA events around each replay, the state rewound
to the prompt before it, as the capture starts). The cross K/V is zeros:
the step's kernels and bytes do not depend on it.

To compare two versions, run ``--steps`` for each tree in turn, parent,
change, change, parent, in one command on one card. Prints the card's
name and power limit, then one JSON line per case. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = (1, 4, 16, 64)
DH = 64
F32_FLOPS = 67e12


def _line(**fields) -> None:
    print(json.dumps(fields), flush=True)


def graph_ms(torch, fn, reps: int = 24) -> float:
    """Device time of one call of ``fn`` among ``reps`` captured in one CUDA
    graph and replayed back to back: the L2 as warm as a decode step leaves
    it, and no host time between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def sweep(torch, C, X, q, k, v, w) -> None:
    """Each launch at every split it takes, the planned one marked, through
    the loaded library with the cold timer."""
    b, h, ta, dh = k.shape
    lib = X._library()
    out_l = torch.empty((b, h, ta), dtype=torch.float32, device=k.device)
    out_m = torch.empty((b, h, dh), dtype=torch.float32, device=k.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for chunk in (64, 128, 256, 512, 1024, ta):
        ms = C.cuda_ms_cold(torch, lambda: lib.cross_logits_launch(
            q.data_ptr(), k.data_ptr(), out_l.data_ptr(), b * h, ta, dh, chunk, stream()))
        _line(case="sweep", launch="logits", rows=b, keys=ta, chunk=chunk, ms=ms,
              planned=chunk == X.plan_logits(b * h, ta, dh))
    for clusters in (1, 2, 4, 8):
        chunk = -(-ta // clusters)
        ms = C.cuda_ms_cold(torch, lambda: lib.cross_mix_launch(
            w.data_ptr(), v.data_ptr(), out_m.data_ptr(), b * h, ta, dh, clusters, chunk,
            stream()))
        _line(case="sweep", launch="mix", rows=b, keys=ta, clusters=clusters, ms=ms,
              planned=(clusters, chunk) == X.plan_mix(b * h, ta, dh))


def kernels(torch, C, H: int, rows) -> None:
    from stt_tpu_torch.models import whisper as W
    from stt_tpu_torch.ops.kernels import cross_mm as X

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in rows:
        for ta in (50, 250, 1500):
            gen = torch.Generator(device=dev).manual_seed(b * 10000 + ta)
            scale = DH ** -0.25
            k, ks = W._q8(torch.randn((b, H, ta, DH), generator=gen, device=dev) * scale)
            v, vs = W._q8(torch.randn((b, H, ta, DH), generator=gen, device=dev))
            q = ((torch.randn((b, H, DH), generator=gen, device=dev) * scale * ks[..., 0])
                 .to(torch.bfloat16).contiguous())
            q4 = q[:, :, None, :]
            logits = X.cross_logits(q, k)
            w = torch.softmax(logits, dim=-1)
            mixed = X.cross_mix(w, v)
            torch.cuda.synchronize()
            errs = {"logits": (logits - X.cross_logits_plain(q, k)).abs().max().item(),
                    "mix": (mixed - X.cross_mix_plain(w, v)).abs().max().item(),
                    "vs_widening": (W._attn_int8_codes(q4, k, v)
                                    - W._attn_cached(q4, k, v)).abs().max().item()}
            bh, n = b * H, b * H * ta * DH
            flops = 2.0 * n
            bytes_logits = q.numel() * 2 + n + bh * ta * 4
            bytes_mix = bh * ta * 4 + n + bh * DH * 4
            bytes_pair = q.numel() * 2 + 2 * n + bh * DH * 4  # the function's own bytes
            cold = {
                "logits": C.cuda_ms_cold(torch, lambda: X.cross_logits(q, k)),
                "mix": C.cuda_ms_cold(torch, lambda: X.cross_mix(w, v)),
                "pair": C.cuda_ms_cold(torch, lambda: W._attn_int8_codes(q4, k, v)),
                "plain_pair": C.cuda_ms_cold(torch, lambda: X.cross_mix_plain(
                    torch.softmax(X.cross_logits_plain(q, k), dim=-1), v)),
                "widening": C.cuda_ms_cold(torch, lambda: W._attn_cached(q4, k, v)),
            }
            warm = {"pair": graph_ms(torch, lambda: W._attn_int8_codes(q4, k, v)),
                    "widening": graph_ms(torch, lambda: W._attn_cached(q4, k, v))}
            bounds = {name: max(nbytes / C.H100_HBM_BYTES, flops_ / F32_FLOPS) * 1e3
                      for name, nbytes, flops_ in (("logits", bytes_logits, flops),
                                                   ("mix", bytes_mix, flops),
                                                   ("pair", bytes_pair, 2 * flops))}
            _line(case="kernels", rows=b, heads=H, keys=ta, dh=DH,
                  plan_logits=X.plan_logits(bh, ta, DH, sms), plan_mix=X.plan_mix(bh, ta, DH, sms),
                  max_abs_err=errs, cold_ms=cold, warm_ms=warm, bound_ms=bounds,
                  bound_share={name: bounds[name] / cold[name] for name in bounds})
            if ta >= 250:
                sweep(torch, C, X, q, k, v, w)


def steps(torch, C, tree: Path, tag: str, model: str, rows) -> None:
    sys.path.insert(0, str(tree))
    import stt_tpu_torch
    from stt_tpu_torch.engine.engine import WhisperEngine
    from stt_tpu_torch.models import whisper as W

    if Path(stt_tpu_torch.__file__).resolve().parent.parent != tree:
        sys.exit(f"stt_tpu_torch came from {stt_tpu_torch.__file__}, not from {tree}")
    engine = WhisperEngine(model, device="cuda", compute_type="bfloat16",
                           batch_buckets=rows, max_batch=max(rows), cross_kv_dtype="int8",
                           xattn_kernel="off", flash_attention="off")
    p_len = len(W.build_prompt(engine.config, "en"))
    modes = (("greedy", 1, False), ("drafted", 1, True), ("beam5", 5, False))
    try:
        for bucket in (5.0, 30.0):
            max_new = engine._max_new_for(bucket)
            for mode, beam, drafted in modes:
                for n in rows:
                    entry = engine.graphs.entry(bucket, n, p_len, max_new, int(bucket * 50),
                                                beam, drafted=drafted)
                    times = []
                    for _ in range(12):
                        entry.state.pos.fill_(p_len)
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                        entry.graph.replay()
                        end.record()
                        end.synchronize()
                        times.append(start.elapsed_time(end) / W.FINISH_CHECK_EVERY)
                    _line(case="step", tree=tag, model=model, mode=mode, bucket_s=bucket, rows=n,
                          step_ms_median=statistics.median(times[2:]),
                          step_ms_min=min(times[2:]), launches=entry.launches)
    finally:
        engine.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="time this checkout's kernels")
    ap.add_argument("--steps", action="store_true", help="time DIR's decode step graphs")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose stt_tpu_torch --steps times")
    ap.add_argument("--tag", default=None, help="name printed with each step line")
    ap.add_argument("--model", default="small", help="model whose decode steps --steps times")
    ap.add_argument("--heads", type=int, default=12, help="heads of the --kernels cases")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="comma-separated row counts (the --steps engine's batch buckets)")
    args = ap.parse_args()
    rows = tuple(int(r) for r in args.rows.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C  # the timers and the card's name, from this checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.gpu_name_and_power(), flush=True)
    if args.kernels:
        kernels(torch, C, args.heads, rows)
    if args.steps:
        tree = args.tree.resolve()
        steps(torch, C, tree, args.tag or str(tree), args.model, rows)


if __name__ == "__main__":
    main()
