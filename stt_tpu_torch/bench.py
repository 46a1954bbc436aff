"""The port's bench: whisper-small RTFx under 64 concurrent 10 s streams.

Counterpart of the engine phase of ``bench.py`` (``bench.py:256-660``) for
``stt_tpu_torch`` on one CUDA card:

    python3 -m stt_tpu_torch.bench [--streams 64] [--secs 10] [--rounds 9] [--profile]

whisper-small in bfloat16 with random weights from seed 0 and batch buckets
1/4/16/64/128. It prewarms the shapes the run hits (the full batch and one
true batch of twice the streams), then keeps two waves of ``--streams``
requests in flight for ``--rounds`` steady rounds plus the fill round, which
is excluded. The headline is RTFx over the median steady round: seconds of
audio per wave over the wave's completion period. The secondary is the same
at twice the streams, each wave one true batch. The line also carries
``mfu_pct`` (the analytic matrix-product FLOPs of ``bench.py:54-84`` over
the median round, against the H100's 989 TFLOP/s dense bf16), the ms per
captured decode step (and per eager step) at the full batch from CUDA
events, the memory reserved after prewarm and the graphs captured while
serving (0 when prewarm covered every shape). ``--profile`` wraps one more
steady round in ``torch.profiler`` (driven from the calling thread, which
the profiler records) and prints to stderr the top device operations by
total time, with counts, their sums by kind, and the device's idle share
of the round.

Then the end-to-end phase (``run_e2e_phase``, counterpart of
``bench.py:87-257``; ``--no-e2e`` skips it): it boots ``python3 -m
stt_tpu_torch.server.main`` as a subprocess on the same device with the
shipped YAML files, the shape matrix narrowed to the shapes the phase
reaches (``e2e_configs``: audio buckets 5 and 10 s, batch buckets 1 and 16,
max batch 16, the beam-5 ``accurate`` profile dropped), waits for its gRPC
channel (the HTTP plane is not ported yet), drives it with the repo's load
tool unchanged (``tools/bench/grpc_load_test.py``: 16 sessions x 2
iterations after 2 warm-up sessions, 5 s of synthetic audio paced at 2x in
100 ms chunks, partials on, language en) in a process of its own, and adds
``e2e_boot_s``, ``e2e_sessions``, ``e2e_error_rate``, ``e2e_create_p95_ms``,
``e2e_first_partial_p95_s`` and ``e2e_final_p95_s`` to the line. If the phase
fails, the line carries ``e2e_error`` instead, still prints, and the bench
exits 1.

Diagnostics go to stderr; the last line of stdout is the JSON result. The
served-partial and drafted phases of ``bench.py`` need modules the port
does not have yet and are left out. ``--device cpu --model test`` runs on
the CPU (for the tests); its times are the host's, and the device-only
fields are null.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent import futures
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import grpc
import numpy as np
import torch
import yaml

from .config.loader import DEFAULT_CONFIG_PATH, DEFAULT_MODEL_CONFIG_PATH, PROJECT_ROOT
from .engine import engine as E
from .models import whisper as W

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM at 700 W
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s
RTFX_BASELINE = 20.0       # bench.py's north-star threshold, RTFx > 20 a chip
BATCH_BUCKETS = (1, 4, 16, 64, 128)  # bench.py's: the served rungs + the 128-row batch
PROMPT_LEN = 4             # sot, language, task, no-timestamps
TIMED_CHUNKS = 12          # decode chunks timed per reading, after 2 of warm-up
E2E_BOOT_WAIT_SEC = 600.0  # whisper-small boots and prewarms its 4 shapes in well under this
E2E_LOAD_ARGS = ["--sessions", "16", "--iterations", "2", "--warmup", "2",
                 "--synthetic-sec", "5", "--speed", "2.0", "--language", "en",
                 "--chunk-ms", "100"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def whisper_request_flops(config, bucket_sec: float, p_len: int, gen_tokens: int) -> float:
    """Analytic FLOPs for one request (own copy of ``bench.py:54-84``):
    encoder over the padded bucket + cross-KV precompute + KV-cached
    decoder steps (prefill + generation); matrix-product FLOPs only."""
    d = config.n_audio_state
    ta = int(bucket_sec * 100) // 2
    t_mel = int(bucket_sec * 100)
    flops = 2 * 3 * config.n_mels * d * t_mel
    flops += 2 * 3 * d * d * (t_mel // 2)
    flops += config.n_audio_layer * (
        2 * 4 * ta * d * d + 2 * 2 * ta * ta * d + 2 * 8 * ta * d * d
    )
    dt = config.n_text_state
    flops += config.n_text_layer * 2 * 2 * ta * dt * dt
    steps = p_len + gen_tokens
    cache = p_len + gen_tokens
    per_step = config.n_text_layer * (
        2 * 4 * dt * dt
        + 2 * 2 * dt * dt
        + 2 * 8 * dt * dt
        + 2 * 2 * cache * dt
        + 2 * 2 * ta * dt
    ) + 2 * dt * config.n_vocab
    flops += steps * per_step
    return float(flops)


def decode_step_bytes(engine: E.WhisperEngine, bucket_sec: float, rows: int) -> int:
    """Bytes one decode step at this shape must move, each read or written
    once: the decoder's weights but its embedding tables, the token table
    in float32 for the logits product, the cross K/V (with int8 scales) and
    the whole self cache (the step attends over every slot), and the logits
    written."""
    cfg, dec = engine.config, engine.model.decoder
    skip = {id(dec.tok), id(dec.pos)}
    weights = sum(p.numel() * p.element_size() for p in dec.parameters() if id(p) not in skip)
    entry = engine.graphs.lookup(bucket_sec, rows, PROMPT_LEN, engine._max_new_for(bucket_sec))
    cross = sum(t.numel() * t.element_size() for t in entry.cross_kv if t is not None)
    self_kv = sum(t.numel() * t.element_size() for t in entry.state.cache)
    return int(weights + cfg.n_vocab * cfg.n_text_state * 4 + cross + self_kv
               + rows * cfg.n_vocab * 4)


def decode_step_ms(engine: E.WhisperEngine, bucket_sec: float, rows: int, *,
                   captured: bool) -> float:
    """Device ms per decode step at (``bucket_sec``, ``rows``) on the
    shape's entry as the last group left it: CUDA events around each chunk,
    replayed (``captured``) or run uncaptured, the first two chunks dropped
    as warm-up, over ``FINISH_CHECK_EVERY`` steps a chunk. The position is
    reset to the prompt's end before a chunk would pass T_max. The events
    of an uncaptured chunk include the device's waits on the host."""
    entry = engine.graphs.lookup(bucket_sec, rows, PROMPT_LEN, engine._max_new_for(bucket_sec))
    dec = engine.model.decoder
    st = entry.state
    pairs = []
    with engine._device_lock, torch.inference_mode():
        for i in range(TIMED_CHUNKS + 2):
            if i % entry.chunks == 0:
                st.pos.fill_(PROMPT_LEN)
                st.finished.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            if captured:
                entry.graph.replay()
            else:
                W._decode_chunk(dec, st, entry.cross_kv)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
    return (sum(s.elapsed_time(e) for s, e in pairs[2:]) / TIMED_CHUNKS
            / W.FINISH_CHECK_EVERY)


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synth_audio(secs: float) -> np.ndarray:
    """``bench.py``'s synthetic speech-band audio (seed 0)."""
    rng = np.random.default_rng(0)
    n = int(secs * 16000)
    t = np.arange(n) / 16000.0
    return (0.1 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(0, 1, n)).astype(np.float32)


def steady_walls(engine: E.WhisperEngine, audio: np.ndarray, streams: int,
                 rounds: int) -> Tuple[List[float], List[int]]:
    """Completion periods of ``rounds`` + 1 waves of ``streams`` requests
    with two waves in flight, the fill round first; and each wave's
    generated tokens."""
    def submit_wave():
        return [engine.submit(E.DecodeRequest(audio=audio, language="en"))
                for _ in range(streams)]

    done_at, tokens = [], []
    t0 = time.perf_counter()
    prev = submit_wave()
    for i in range(rounds + 1):
        nxt = submit_wave() if i < rounds else None
        futures.wait(prev)
        done_at.append(time.perf_counter() - t0)
        tokens.append(sum(f.result()._n_gen for f in prev))
        prev = nxt
    walls = [done_at[0]] + [b - a for a, b in zip(done_at, done_at[1:])]
    return walls, tokens


def kind_of(name: str) -> str:
    """A device operation's kind, from its kernel name: the port's kernels,
    matrix products (cuBLAS's ``nvjet`` kernels and split-K reductions on
    bf16 are the decoder's bf16 linear layers; ``gemv``/``gemm`` kernels on
    float32 are the attention products and the float32 logits product),
    copies and type conversions, and the rest."""
    low = name.lower()
    if "xattn" in low:
        return "xattn_decode"
    if "flash" in low:
        return "flash_attention"
    if "mel" in low and "kernel" in low:
        return "log-mel"
    if low.startswith("nvjet") or (("gemm" in low or "splitk" in low)
                                   and ("bf16" in low or "bfloat16" in low)):
        return "matrix products, bf16"
    if any(k in low for k in ("gemm", "gemv", "xmma")):
        return "matrix products, float32"
    if "memcpy" in low or "memset" in low or "copy_kernel" in low:
        return "copies and type conversions"
    return "other"


def profile_round(engine: E.WhisperEngine, audio: np.ndarray, streams: int,
                  top: int = 30) -> Dict[str, Any]:
    """One steady round under ``torch.profiler``: the completion period of
    a wave of ``streams`` requests (one group) while the next wave is in
    flight, as the engine's two threads pipeline them, driven here from
    the calling thread (the profiler records the operations of the thread
    that runs it) with the same device phase and harvest. Prints the top
    device operations inside the round by total time, with counts, their
    sums by kind (:func:`kind_of`), and the device's idle share of the
    round (1 - the union of device-operation intervals over the round)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def wave():
        return [E._Task(E.DecodeRequest(audio=audio, language="en"), None)
                for _ in range(streams)]

    first = engine._device_phase(wave())
    second = engine._device_phase(wave())
    engine._harvest(first)  # the device now runs the second wave
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("steady round"):
            third = engine._device_phase(wave())
            engine._harvest(second)
        torch.cuda.synchronize()
    engine._harvest(third)
    events = prof.events()
    window = [e for e in events if e.name == "steady round"
              and e.device_type == torch.autograd.DeviceType.CPU]
    # device operations, without the round's own range mirrored on the device
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != "steady round" and not getattr(e, "is_user_annotation", False)]
    if not window or not device:
        log(f"profile: torch.profiler recorded {len(device)} device operations and "
            f"{len(window)} round ranges")
        return {"profile_device_ops": len(device)}
    lo, hi = window[0].time_range.start, window[0].time_range.end
    totals: Dict[str, List[float]] = {}
    spans = []
    for e in device:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        entry = totals.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += t - s
        spans.append((s, t))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    wall = hi - lo
    total_dev = sum(t for _, t in totals.values())
    log(f"profile: one steady round of {streams} requests, {wall / 1e3:.3f} ms, "
        f"{len(spans)} device operations in it, {total_dev / 1e3:.3f} ms of device time, "
        f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall:.4f}")
    kinds: Dict[str, List[float]] = {}
    for name, (count, t) in totals.items():
        k = kinds.setdefault(kind_of(name), [0, 0.0])
        k[0] += count
        k[1] += t
    for kind, (count, t) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
        log(f"profile kind {kind}: {t / 1e3:.3f} ms in {count} operations "
            f"({t / total_dev:.2%} of device time)")
    for name, (count, t) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile op {t / 1e3:10.3f} ms  x{count:<6d} {t / count:9.2f} us each  "
            f"{name[:150]}")
    return {"profile_device_ops": len(spans),
            "profile_idle_share": 1 - busy / wall,
            "profile_round_ms": wall / 1e3,
            "profile_kinds_ms": {k: t / 1e3 for k, (_, t) in kinds.items()}}


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """The bench; returns the result line's fields."""
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA card, and torch.cuda.is_available() "
                           "is false; pass --device cpu to run it on the host")
    if args.profile and not on_card:
        raise RuntimeError("--profile reads the card's operations; it needs --device cuda")
    card = card_name_and_power() if on_card else "cpu"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("left out: the served-partial and drafted phases of bench.py "
        "(their modules are not ported yet; ROADMAP.md Queue 1 item 6)")
    t0 = time.monotonic()
    engine = E.WhisperEngine(
        args.model, device=args.device, compute_type="bfloat16", max_batch=args.streams,
        batch_window_ms=5.0, batch_buckets=BATCH_BUCKETS, seed=0,
    )
    log(f"engine: whisper-{args.model} bfloat16, policy {engine.policy}, "
        f"wire {engine.audio_wire}, pipeline depth {engine.pipeline_depth}; built in "
        f"{time.monotonic() - t0:.1f} s")
    try:
        audio = synth_audio(args.secs)
        bucket = engine._bucket_for(len(audio))
        rows = engine._batch_bucket(args.streams)
        streams2 = 2 * args.streams
        rows2 = engine._batch_bucket(streams2)
        prewarm_s = engine.prewarm([bucket], sorted({rows, rows2}))
        reserved = torch.cuda.memory_reserved() if on_card else None
        log(f"prewarm {bucket:g} s x {sorted({rows, rows2})} rows: {prewarm_s:.2f} s, "
            f"{engine.graph_captures} graphs captured"
            + (f", {reserved / 2**30:.3f} GiB reserved" if on_card else ""))
        captures0 = engine.graph_captures

        walls, tokens = steady_walls(engine, audio, args.streams, args.rounds)
        log(f"round 0 (pipeline fill, excluded): {walls[0]:.4f} s")
        for i, (wall, n) in enumerate(zip(walls[1:], tokens[1:])):
            log(f"round {i + 1}: {wall:.4f} s, {n} tokens generated")
        steady = sorted(walls[1:])
        med_wall, best_wall = statistics.median(steady), steady[0]
        total_audio = args.streams * args.secs
        rtfx, rtfx_best = total_audio / med_wall, total_audio / best_wall
        gen_tokens = tokens[-1]
        flops = args.streams * whisper_request_flops(
            engine.config, bucket, PROMPT_LEN, max(1, gen_tokens // args.streams))
        mfu = 100.0 * flops / med_wall / H100_BF16_FLOPS if on_card else None
        log(f"RTFx {rtfx:.2f} ({total_audio:g} s of audio / median {med_wall:.4f} s; best "
            f"{best_wall:.4f} s -> {rtfx_best:.2f}, worst {steady[-1]:.4f} s); "
            f"{flops / 1e12:.3f} TFLOP a round"
            + (f", {mfu:.3f}% of 989 TFLOP/s" if on_card else ""))

        engine.max_batch = max(engine.max_batch, streams2)
        walls2, _ = steady_walls(engine, audio, streams2, args.rounds)
        rtfx2 = streams2 * args.secs / statistics.median(walls2[1:])
        log(f"RTFx at {streams2} streams, one true batch of {rows2} rows: {rtfx2:.2f} "
            f"(median of {len(walls2) - 1} steady rounds)")
        engine.max_batch = args.streams

        result: Dict[str, Any] = {
            "metric": f"rtfx_whisper_{args.model}_{args.streams}streams",
            "value": round(rtfx, 2),
            "unit": "x_realtime_per_chip",
            "vs_baseline": round(rtfx / RTFX_BASELINE, 3),
            "rtfx_best": round(rtfx_best, 2),
            "wall_median_s": round(med_wall, 4),
            "wall_min_s": round(best_wall, 4),
            "wall_max_s": round(steady[-1], 4),
            "mfu_pct": None if mfu is None else round(mfu, 3),
            f"rtfx_{streams2}streams": round(rtfx2, 2),
            "ms_per_decode_step": None,
            "ms_per_decode_step_eager": None,
            "decode_step_bound_ms": None,
            "prewarm_s": round(prewarm_s, 2),
            "memory_reserved_gib": None if reserved is None else round(reserved / 2**30, 3),
            "graph_replays": engine.graph_replays,
            "card": card,
            "device": str(engine.device),
        }
        if on_card:
            step = decode_step_ms(engine, bucket, rows, captured=True)
            eager = decode_step_ms(engine, bucket, rows, captured=False)
            step_bytes = decode_step_bytes(engine, bucket, rows)
            bound = step_bytes / H100_HBM_BYTES * 1e3
            log(f"decode step at {rows} x {bucket:g} s: captured {step:.4f} ms, eager "
                f"{eager:.4f} ms; {step_bytes / 1e6:.1f} MB a step, bound {bound:.4f} ms "
                f"at 3.35 TB/s")
            result.update(ms_per_decode_step=round(step, 4),
                          ms_per_decode_step_eager=round(eager, 4),
                          decode_step_bound_ms=round(bound, 4))
        if args.profile:
            result.update(profile_round(engine, audio, args.streams))
        result["graph_captures_serving"] = engine.graph_captures - captures0
        return result
    finally:
        engine.close()


def e2e_configs(directory: Path) -> Tuple[Path, Path]:
    """Writes into ``directory`` the shipped ``config/server.yaml`` and
    ``config/model.yaml`` with the shape matrix narrowed as ``bench.py``
    narrows it (``bench.py:145-158``): audio buckets 5 and 10 s, batch
    buckets 1 and 16, max batch 16, and the beam-5 ``accurate`` profile
    dropped. Returns (server config, model config)."""
    server_cfg = yaml.safe_load(DEFAULT_CONFIG_PATH.read_text())
    server_cfg.setdefault("server", {})["max_decode_batch_size"] = 16
    server_cfg.setdefault("tpu", {})["audio_buckets_sec"] = [5.0, 10.0]
    server_cfg["tpu"]["batch_buckets"] = [1, 16]
    model_cfg = yaml.safe_load(DEFAULT_MODEL_CONFIG_PATH.read_text())
    model_cfg["model"]["decode_profiles"].pop("accurate", None)
    paths = directory / "server.yaml", directory / "model.yaml"
    for path, cfg in zip(paths, (server_cfg, model_cfg)):
        path.write_text(yaml.safe_dump(cfg))
    return paths


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_e2e_phase(args: argparse.Namespace) -> Dict[str, Any]:
    """The serving stack end to end: the port's server as a subprocess on
    the bench's device, driven by the load tool in a process of its own;
    returns the ``e2e_*`` fields. Raises if the server does not boot, the
    load tool fails or the server does not stop on SIGTERM with exit 0."""
    with tempfile.TemporaryDirectory(prefix="stt_torch_e2e_") as tmp:
        tmp = Path(tmp)
        cfg_path, model_cfg_path = e2e_configs(tmp)
        port = _free_port()
        log_path = tmp / "server.log"
        cmd = [sys.executable, "-m", "stt_tpu_torch.server.main",
               "--config", str(cfg_path), "--model-config", str(model_cfg_path),
               "--model", args.model, "--model-backend", "torch_whisper",
               "--device", args.device, "--compute-type", "bfloat16",
               "--port", str(port), "--ws-port", "0"]
        log(f"e2e: starting the server on port {port}")
        with open(log_path, "w") as server_log:
            proc = subprocess.Popen(cmd, cwd=PROJECT_ROOT, stdout=server_log,
                                    stderr=subprocess.STDOUT, start_new_session=True)
        try:
            t0 = time.monotonic()
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                while True:
                    if proc.poll() is not None:
                        raise RuntimeError(f"server exited rc={proc.returncode} during boot: "
                                           f"{log_path.read_text()[-1500:]}")
                    try:
                        grpc.channel_ready_future(channel).result(timeout=2.0)
                        break
                    except grpc.FutureTimeoutError:
                        if time.monotonic() - t0 > E2E_BOOT_WAIT_SEC:
                            raise RuntimeError(
                                f"server not ready after {E2E_BOOT_WAIT_SEC:g} s") from None
            boot_sec = time.monotonic() - t0
            log(f"e2e: server ready in {boot_sec:.1f} s; driving load")
            out_dir = tmp / "load"
            load = subprocess.run(
                [sys.executable, str(PROJECT_ROOT / "tools" / "bench" / "grpc_load_test.py"),
                 "--target", f"127.0.0.1:{port}", *E2E_LOAD_ARGS, "--out-dir", str(out_dir)],
                cwd=PROJECT_ROOT, capture_output=True, text=True, timeout=420,
            )
            if load.returncode != 0:
                raise RuntimeError(f"load tool rc={load.returncode}: {load.stderr[-800:]}")
            summary = json.loads((out_dir / "summary.json").read_text())
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)
                raise RuntimeError("server did not stop within 60 s of SIGTERM") from None
            for line in log_path.read_text().splitlines():
                if "prewarmed" in line or "WARNING" in line:
                    log(f"e2e server: {line}")
        if rc != 0:
            raise RuntimeError(f"server exited rc={rc} on SIGTERM: "
                               f"{log_path.read_text()[-1500:]}")

    def p95(section: str) -> Optional[float]:
        val = (summary.get(section) or {}).get("p95")
        return None if val is None else float(val)

    create, first_partial, final = (p95(s) for s in (
        "create_latency_sec", "first_partial_sec", "final_latency_sec"))
    out = {
        "e2e_boot_s": round(boot_sec, 1),
        "e2e_sessions": summary.get("sessions"),
        "e2e_error_rate": summary.get("error_rate"),
        "e2e_create_p95_ms": None if create is None else round(create * 1000, 1),
        "e2e_first_partial_p95_s": None if first_partial is None else round(first_partial, 3),
        "e2e_final_p95_s": None if final is None else round(final, 3),
    }
    log(f"e2e: {out}; summary: {json.dumps(summary)}")
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--streams", type=int, default=64)
    parser.add_argument("--secs", type=float, default=10.0,
                        help="utterance length of every request")
    parser.add_argument("--rounds", type=int, default=9,
                        help="steady rounds measured (the median is the headline)")
    parser.add_argument("--model", default="small")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--profile", action="store_true",
                        help="profile one more steady round (stderr)")
    parser.add_argument("--no-e2e", dest="e2e", action="store_false",
                        help="skip the end-to-end phase (the server and the load tool)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    result = run(args)
    if args.e2e:
        # the engine phase is over: hand the card's cached memory back
        # before the server process takes its own
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        try:
            result.update(run_e2e_phase(args))
        except Exception as exc:  # recorded in the line, which still prints
            log(f"e2e phase failed: {exc}")
            result["e2e_error"] = str(exc)[:300]
    print(json.dumps(result), flush=True)
    if "e2e_error" in result:
        sys.exit(1)


if __name__ == "__main__":
    main()
