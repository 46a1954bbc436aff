#!/usr/bin/env python3
"""Drive stt_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card, nvcc and
PyTorch built for CUDA. In order:

1. prints the card's name and power limit, builds every kernel of the
   paths from the sources in the checkout (one ``nvcc`` per source, all
   started together, no network) and prints each build time and each
   kernel's registers, shared memory and spills as ``ptxas -v`` gives them;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it and a few more, with the tolerance
   stated, and times kernel, plain version and one PyTorch library call:
   log-mel (atol 2e-4, rtol 1e-4; every wire, 80 and 128 mels, the groups
   the served phases form), cross-attention decode over bf16, fp8, int8 and
   float32 K/V (atol 1e-3, rtol 1e-2) and encoder flash attention (bf16
   body atol 2e-3, rtol 1e-2; float32 body atol 1e-5, rtol 1e-5), each
   case printing the share of its limit used and the kernel's share of its
   bound; the cross-attention decode cases cover every cluster size the
   split planner picks (1, 2, 4, 8 and 16 blocks) and Ta above the
   one-block cap of earlier versions; the float32 flash cases include the
   served 1/4/16/64 rows x 12 heads x 1500, each naming its key split and
   the grid's waves, and at 1 and 4 rows every key split is timed too.
   Every time is read with the L2 cache flushed and the device spinning
   until the host has enqueued the call (``cuda_ms_cold``); log-mel also
   prints each call's host enqueue time and, in a second column, the
   back-to-back reading of earlier versions;
3. serves two paths with whisper-small in bfloat16 at full width and
   random weights from seed 0, each with the launch counts set to 0 just
   before and read just after:
   a. the default path (int8 cross K/V, einsum attention): 8 concurrent
      requests of 1, 2, 5 and 10 s of synthetic audio from 8 threads, on
      the default mu-law wire and again with ``audio_wire="int16"``, each
      checking the row type every log-mel launch received;
   b. the 30 s path (fp8 cross K/V, ``xattn_kernel="mm"``,
      ``flash_attention="auto"``): 4 concurrent requests of 12, 20, 25 and
      30 s, all in the 30 s bucket, the only one whose 1500 encoder
      positions reach flash attention's 512;
   each engine first prewarms the shapes its requests reach (every bucket
   of the path at 1 and 4 rows), which captures their decode graphs, and
   the phase fails if a graph is captured while the requests are served;
   it checks every output, that requests shared a batch, and from the
   launch counts that each path ran through its kernels (path b: flash
   once per encoder layer per encode, cross-attention decode once per
   decoder layer per single-position step, where the steps inside a
   captured decode chunk count as the launches the capture recorded times
   the chunk's replays); after each run it times the log-mel kernel
   against the whole encode at the path's buckets (the front end's share
   of an encode);
   c. the decode graphs: at phase a's group (4 rows x 10 s), phase b's (4
   x 30 s) and the ``test`` model in float32 (4 x 10 s), one group decoded
   twice on its prewarmed entry, by replaying the captured chunk and by
   running the same chunk uncaptured, must give bitwise-identical tokens,
   lengths and logprob sums (the same kernels in the same order); each
   prints the ms per decode step of both (CUDA events) beside the step's
   bound (its bytes over the card's memory rate);
   d. one round of the port's bench (``stt_tpu_torch/bench.py``) at 64
   streams of 10 s, printing its JSON line;
4. checks the outputs against references on small inputs: the ``test``
   model in float32 on the card against the CPU (encoder output and
   teacher-forced logits within max abs 1e-3), once at 1.5 s with flash
   off and once at a 30 s window with flash on (the kernel's float32 body,
   launched once per encoder layer), with TF32 off in cuBLAS and cuDNN;
   and in bfloat16 with fp8 cross K/V and both attention kernels on, at a
   30 s window, against the same model on the CPU through the plain
   versions (encoder output within max abs 0.05, three teacher-forced
   decode steps' logits within 1e-2);
5. serves the gRPC streaming path (run after 3d, before 4's references):
   the port's server built in-process with the calls ``serve()`` makes
   (``ApplicationRuntime``, ``build_grpc_server``, ``STTGrpcServicer``,
   ``bind_grpc_port``) from the shipped YAML files with the shape matrix
   narrowed as the bench's end-to-end phase narrows it (audio buckets 5
   and 10 s, batch buckets 1 and 16, max batch 16, no ``accurate``
   profile), whisper-small bf16 on the shipped attention policy, language
   en; 8 concurrent sessions through the port's own stubs, each streaming
   5 s of the load tool's synthetic audio (tone bursts with a mid-stream
   silence gap, ending in speech) in 100 ms chunks at 2x real time with
   partials on, then ``is_final``. It fails unless every session gets a
   final with text, language en and ``0 <= start <= end <= 5.5``, a
   trailing ``stt-decode-inference-sec`` above 0 and no error status, no
   decode graph was captured after boot, and the log-mel kernel was
   launched (its count set to 0 just before the traffic). It prints the
   boot time, the shapes prewarmed, the client's first-partial and final
   latency p50/p95 and the medians of the four trailing
   ``stt-decode-*-sec`` values over the finals, then stops the server;
6. closes the engines, then prints one JSON line describing each kernel
   and, last, ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the final line; so does a host
without CUDA, and a directory that holds this script but not the package.
A watchdog ends a hung run with a traceback.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WATCHDOG_SEC = 600
MEL_ATOL, MEL_RTOL = 2e-4, 1e-4          # tests/test_pallas_mel.py:28
REF_ATOL = 1e-3                          # float32 card vs float32 CPU, test model
# kernel vs plain, set from the values at the served shapes: outputs there
# are ~0.03-0.05 (scores of unit variance over 500-1500 keys); both sides
# round the weights to bf16, so xattn_decode differs only where a weight's
# float32 value falls on the other side of a bf16 rounding step, and flash
# by one bf16 step of its output (< 0.8% of |x|) on top of that
XATTN_ATOL, XATTN_RTOL = 1e-3, 1e-2
FLASH_ATOL, FLASH_RTOL = 2e-3, 1e-2
# the float32 body rounds nothing below float32: kernel and plain version
# differ only in the order of float32 sums over up to 1500 keys
FLASH_F32_ATOL, FLASH_F32_RTOL = 1e-5, 1e-5
BF16_REF_ATOL = 0.05                     # encoder, tests/test_torch_whisper.py:31
BF16_LOGITS_ATOL = 1e-2                  # decode-step logits, |logits| < 1 here
H100_F32_FLOPS = 67e12                   # CUDA-core float32 peak, SXM, 700 W
H100_BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak, SXM, 700 W
H100_HBM_BYTES = 3.35e12                 # HBM3 bytes/s
L2_FLUSH_BYTES = 256 * 1024 * 1024       # > the 50 MB L2: a cold cache per timed call
SPIN_CYCLES = 1_000_000                  # device spin after each flush, ~0.5 ms
KERNELS = ("mel", "xattn_decode", "flash_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def limit_used(got, ref, atol: float, rtol: float) -> float:
    """The largest share of its limit that an element's error takes (1 is
    the edge of ``torch.testing.assert_close`` at these tolerances)."""
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SPIN_MS = {}


def spin_ms(torch, cycles: int) -> float:
    """Device time of one ``torch.cuda._sleep(cycles)``, read once."""
    if cycles not in _SPIN_MS:
        torch.cuda._sleep(cycles)  # warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN_MS[cycles] = start.elapsed_time(end)
    return _SPIN_MS[cycles]


def cuda_ms_cold(torch, fn, iters: int = 20, warmup: int = 3, report=None) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each call
    (CUDA events around each call), as the decode loop meets each layer's
    cross K/V cold. After the flush the device also spins (~0.5 ms), so the
    host has enqueued the timed call before the device reaches its start
    event: the events then time the device alone, however slow the host (a
    call of ~10 us otherwise read up to 4x high on a busy host). The spin
    covers the call's host enqueue, timed once with the device idle: where
    twice the enqueue runs past ~0.5 ms (a call of many launches), the spin
    is made 4x as long until it does (up to 64x). ``report``, when given,
    receives that enqueue, the spin and the longest enqueue inside the timed
    loop, in ms; the last reaches the spin only for a call that waits on
    the device (a copy from pageable host memory), whose reading then
    includes host time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    while spin_ms(torch, cycles) < 2e3 * enqueue and cycles < 64 * SPIN_CYCLES:
        cycles *= 4
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    in_loop = 0.0
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        in_loop = max(in_loop, time.perf_counter() - t0)
    torch.cuda.synchronize()
    if report is not None:
        report.update(enqueue_ms=enqueue * 1e3, spin_ms=spin_ms(torch, cycles),
                      in_loop_ms=in_loop * 1e3)
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(nbytes: float, flops: float, peak_flops: float):
    """Least time for the work (ms) and what binds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Speech-like test signal: a gliding harmonic tone with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 40.0 * seed + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (sig + 0.02 * rng.normal(0, 1, t.shape)).astype(np.float32)


def serve_concurrently(engine, requests, timeout: float = 300.0):
    """Submit every request from its own thread at once; returns the
    (output, latency) pairs and the wall time. Fails unless all complete."""
    barrier = threading.Barrier(len(requests))
    results = [None] * len(requests)
    errors = []

    def client(i: int) -> None:
        try:
            barrier.wait(timeout=60)
            t_sub = time.monotonic()
            out = engine.submit(requests[i]).result(timeout=timeout)
            results[i] = (out, time.monotonic() - t_sub)
        except Exception as exc:  # reported below; the phase fails
            errors.append(f"request {i}: {exc!r}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(requests))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 60)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads) or None in results:
        fail(f"served requests did not all complete: {errors}")
    return results, wall


def check_served(E, W, engine, requests, results) -> None:
    """Every output well formed (tokens in the vocabulary and within the
    bucket's decode bound, a known language, finite scores), and at least
    two requests in one batch."""
    cfg = engine.config
    for i, (out, latency) in enumerate(results):
        toks = out._tokens
        gen = toks[out._p_len: out._p_len + out._n_gen]
        n_audio = len(requests[i].audio)
        if (toks.min() < 0 or toks.max() >= cfg.n_vocab or out._n_gen > 224
                or out._n_gen > E.max_new_for(engine._bucket_for(n_audio), 224)):
            fail(f"request {i}: malformed tokens (n_gen {out._n_gen})")
        if out.info.language not in W.WHISPER_LANG_CODES or not (
                0.0 < out.info.language_probability <= 1.0):
            fail(f"request {i}: bad language {out.info}")
        if not (np.isfinite(out.avg_logprob) and 0.0 <= out.no_speech_prob <= 1.0):
            fail(f"request {i}: non-finite scores {out.avg_logprob} {out.no_speech_prob}")
        log(f"request {i}: {n_audio / 16000:g} s audio, latency {latency:.3f} s, "
            f"batch_rows {out.batch_rows}, n_gen {out._n_gen}, language "
            f"{out.info.language} ({out.info.language_probability:.3f}), "
            f"first tokens {gen[:6].tolist()}")
    if max(out.batch_rows for out, _ in results) < 2:
        fail("no two requests shared a batch")


def xattn_phase(torch, dev):
    """Phase 2 for the cross-attention decode kernel; returns the largest
    error and the numbers of the served path's case (4 rows x 1500 fp8)."""
    import torch.nn.functional as F
    from stt_tpu_torch.ops.kernels.xattn_decode import (
        plan_split, xattn_decode, xattn_decode_plain,
    )

    def inputs(storage, b, ta, h, dh=64, seed=0):
        """q and K at whisper's d_head**-0.25 scale; int8 as the model
        stores it, with its per-(row, head) scales folded into q and
        returned for the output."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        scale = dh ** -0.25
        q = (torch.randn((b, h, dh), generator=gen, device=dev) * scale).to(torch.bfloat16)
        k = torch.randn((b, h, ta, dh), generator=gen, device=dev) * scale
        v = torch.randn((b, h, ta, dh), generator=gen, device=dev)
        if storage == "float32":
            return q, k, v, None
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        if storage == "fp8":
            return q, k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn), None
        if storage == "int8":
            def q8(x):
                sc = torch.clamp_min(x.float().abs().amax(dim=(2, 3), keepdim=True) / 127.0,
                                     1e-12)
                return torch.round(x.float() / sc).to(torch.int8), sc[..., 0]
            (kq, ks), (vq, vs) = q8(k), q8(v)
            return (q * ks.to(torch.bfloat16)).contiguous(), kq, vq, vs
        return q, k, v, None

    cases = [(st, b, ta, 12) for b, ta in [(1, 50), (4, 500), (4, 1500), (16, 1500), (64, 500)]
             for st in ("bf16", "fp8", "int8")]
    cases += [("float32", 4, 500, 12), ("bf16", 4, 1500, 20)]
    # Ta above the one-block cap of the earlier kernel (8,128 fp8 keys), then
    # above 8 x CHUNK_MAX, which takes a non-portable cluster of 16
    cases += [("fp8", 1, 20000, 12), ("bf16", 1, 70000, 2)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, headline, sizes = 0.0, None, set()
    for storage, b, ta, h in cases:
        q, k, v, vs = inputs(storage, b, ta, h)
        got = xattn_decode(q, k, v)
        ref = xattn_decode_plain(q, k, v)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        lib = torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kb, vb, scale=1.0)[:, :, 0, :].float()
        if vs is not None:
            got, ref, lib = got * vs, ref * vs, lib * vs
        torch.cuda.synchronize()
        clusters, chunk = plan_split(b * h, ta, 64, k.element_size(), sms)
        sizes.add(clusters)
        tag = f"xattn_decode B{b} H{h} Ta{ta} {storage} (cluster {clusters} x {chunk} keys)"
        if got.shape != (b, h, 64) or not torch.isfinite(got).all():
            fail(f"{tag}: shape {tuple(got.shape)} or non-finite values")
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        used = limit_used(got, ref, XATTN_ATOL, XATTN_RTOL)
        try:
            torch.testing.assert_close(got, ref, atol=XATTN_ATOL, rtol=XATTN_RTOL)
        except AssertionError as exc:
            fail(f"{tag}: kernel disagrees with plain: {exc}")
        k_ms = cuda_ms_cold(torch, lambda: xattn_decode(q, k, v))
        p_ms = cuda_ms_cold(torch, lambda: xattn_decode_plain(q, k, v))
        q4 = q[:, :, None, :]
        l_ms = cuda_ms_cold(torch, lambda: F.scaled_dot_product_attention(q4, kb, vb, scale=1.0))
        nbytes = (q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
                  + got.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * b * h * ta * 64, H100_BF16_FLOPS)
        lib_err = (lib - ref).abs().max().item()
        log(f"{tag}: max_abs_err {err:.3g} (library {lib_err:.3g}), {used:.3g} of the limit, "
            f"max |ref| {ref.abs().max().item():.3g}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}), "
            f"{b_ms / k_ms:.1%} of the bound, {nbytes / 1e6:.2f} MB")
        if (storage, b, ta, h) == ("fp8", 4, 1500, 12):
            headline = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                            bound_by=b_by)
    if sizes != {1, 2, 4, 8, 16}:
        fail(f"xattn_decode cases ran cluster sizes {sorted(sizes)}, not 1, 2, 4, 8 and 16")
    return worst, headline


def split_sweep(torch, q, k, v, planned: int) -> None:
    """Times the float32 flash body at every key split its launcher takes
    (the planner's pick among them) on (B, H, T, Dh) q/k/v, checking each
    against the planned split's output at the float32 limit."""
    from stt_tpu_torch.ops.kernels.flash_attention import (
        F32_KEYS, F32_MAX_SPLIT, _launcher, flash_attention,
    )

    b, h, t, dh = q.shape
    launch = _launcher(torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    ref = flash_attention(q, k, v)
    out = torch.empty_like(q)
    n_tiles = -(-t // F32_KEYS)
    times = {}
    for splits in range(1, F32_MAX_SPLIT + 1):
        if -(-n_tiles // -(-n_tiles // splits)) != splits:
            continue
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, dh,
                splits, stream)
        if launch(*args) != 0:
            fail(f"flash_attention float32 B{b}: the launcher refused {splits} key splits")
        torch.cuda.synchronize()
        try:
            torch.testing.assert_close(out, ref, atol=FLASH_F32_ATOL, rtol=FLASH_F32_RTOL)
        except AssertionError as exc:
            fail(f"flash_attention float32 B{b}, {splits} key splits: {exc}")
        times[splits] = cuda_ms_cold(torch, lambda: launch(*args))
    best = min(times, key=times.get)
    log(f"flash_attention B{b} H{h} T{t} float32 key splits: "
        + ", ".join(f"{n} {ms:.4f} ms" for n, ms in times.items())
        + f"; the planner picks {planned}, the fastest here is {best}")


def flash_phase(torch, dev):
    """Phase 2 for the encoder flash-attention kernel, bf16 body then float32
    body; returns the bf16 body's largest error and the numbers of its
    served case (4 rows x 1500), then the float32 body's numbers at 4 x 1500
    with its largest error."""
    import torch.nn.functional as F
    from stt_tpu_torch.ops.kernels.flash_attention import (
        f32_waves, flash_attention, flash_attention_plain, plan_f32,
    )

    worst, headline = 0.0, None
    h, dh = 12, 64
    for b, t in [(1, 512), (1, 1500), (4, 1500), (16, 1500), (2, 600)]:
        gen = torch.Generator(device=dev).manual_seed(b * 10000 + t)
        scale = dh ** -0.25
        q, k, v = ((torch.randn((b, h, t, dh), generator=gen, device=dev) * sc).to(torch.bfloat16)
                   for sc in (scale, scale, 1.0))
        got = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        lib = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        torch.cuda.synchronize()
        tag = f"flash_attention B{b} H{h} T{t} bf16"
        if got.shape != q.shape or got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
            fail(f"{tag}: shape {tuple(got.shape)}, {got.dtype} or non-finite values")
        err = (got.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        used = limit_used(got.float(), ref.float(), FLASH_ATOL, FLASH_RTOL)
        try:
            torch.testing.assert_close(got.float(), ref.float(), atol=FLASH_ATOL,
                                       rtol=FLASH_RTOL)
        except AssertionError as exc:
            fail(f"{tag}: kernel disagrees with plain: {exc}")
        k_ms = cuda_ms_cold(torch, lambda: flash_attention(q, k, v))
        p_ms = cuda_ms_cold(torch, lambda: flash_attention_plain(q, k, v))
        l_ms = cuda_ms_cold(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
        b_ms, b_by = bound(4 * q.numel() * 2, 4.0 * b * h * t * t * dh, H100_BF16_FLOPS)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        log(f"{tag}: max_abs_err {err:.3g} (library {lib_err:.3g}), {used:.3g} of the limit, "
            f"max |ref| {ref.abs().max().item():.3g}, mean |ref| "
            f"{ref.float().abs().mean().item():.3g}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}), "
            f"{b_ms / k_ms:.1%} of the bound, "
            f"{4.0 * b * h * t * t * dh / k_ms / 1e9:.0f} TFLOP/s")
        if (b, t) == (4, 1500):
            headline = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                            bound_by=b_by)

    # the float32 body (engines built with compute_type="float32"); its plain
    # version and SDPA run with TF32 off (set in main). The served shapes are
    # 12 heads x 1500 at the row buckets 1/4/16/64; each line names the key
    # split the planner picked and the grid's waves (blocks over the blocks
    # the card holds at once)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the float32 plain version and SDPA would round to ~3 digits")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst32, headline32 = 0.0, None
    for b, h, t, dh in [(1, 12, 512, 64), (4, 12, 1500, 64), (2, 12, 600, 64),
                        (3, 4, 333, 64), (2, 2, 1500, 32), (2, 3, 512, 16),
                        (1, 12, 1500, 64), (16, 12, 1500, 64), (64, 12, 1500, 64)]:
        gen = torch.Generator(device=dev).manual_seed(b * 10000 + t + dh)
        scale = dh ** -0.25
        q, k, v = (torch.randn((b, h, t, dh), generator=gen, device=dev) * sc
                   for sc in (scale, scale, 1.0))
        got = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        lib = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        torch.cuda.synchronize()
        tag = f"flash_attention B{b} H{h} T{t} Dh{dh} float32"
        if got.shape != q.shape or got.dtype != torch.float32 or not torch.isfinite(got).all():
            fail(f"{tag}: shape {tuple(got.shape)}, {got.dtype} or non-finite values")
        err = (got - ref).abs().max().item()
        worst32 = max(worst32, err)
        used = limit_used(got, ref, FLASH_F32_ATOL, FLASH_F32_RTOL)
        try:
            torch.testing.assert_close(got, ref, atol=FLASH_F32_ATOL, rtol=FLASH_F32_RTOL)
        except AssertionError as exc:
            fail(f"{tag}: kernel disagrees with plain: {exc}")
        lib_err = (lib - ref).abs().max().item()
        ref_max, ref_mean = ref.abs().max().item(), ref.abs().mean().item()
        del lib, ref
        iters = 5 if b * h * t * t > 1e9 else 20  # the plain version's logits: 6.9 GB at 64 rows
        k_ms = cuda_ms_cold(torch, lambda: flash_attention(q, k, v))
        p_ms = cuda_ms_cold(torch, lambda: flash_attention_plain(q, k, v), iters=iters)
        l_ms = cuda_ms_cold(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
                            iters=iters)
        flops = 4.0 * b * h * t * t * dh
        b_ms, b_by = bound(4 * q.numel() * 4, flops, H100_F32_FLOPS)
        splits = plan_f32(b * h, t, sms)
        log(f"{tag}: max_abs_err {err:.3g} (library {lib_err:.3g}), {used:.3g} of the limit, "
            f"max |ref| {ref_max:.3g}, mean |ref| {ref_mean:.3g}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
            f"{b_ms:.4g} ms ({b_by}), {b_ms / k_ms:.1%} of the bound, "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s; {splits} key split(s), "
            f"{f32_waves(b * h, t, splits, sms):.2f} waves")
        if (b, t, dh) == (4, 1500, 64):
            headline32 = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                              bound_by=b_by)
        if h == 12 and t == 1500 and b in (1, 4):
            split_sweep(torch, q, k, v, splits)
    headline32["max_abs_err"] = worst32
    return worst, headline, headline32


def front_end_share(torch, E, engine, seconds_list, wire: str) -> None:
    """Prints the log-mel kernel's device time against the whole encode
    (``_mel_encode``: log-mel, normalisation, encoder) on 4 rows (the batch
    bucket the served groups take) of each bucket length: the front end's
    share of an encode."""
    for seconds in seconds_list:
        audio = np.stack([synth_audio(seconds, seed=i) for i in range(4)])
        pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        rows = torch.from_numpy(E._encode_wire_rows(pcm, wire)).to(engine.device)
        with torch.inference_mode():
            mel_ms = cuda_ms_cold(torch, lambda: E.mel_logspec(rows, engine.config.n_mels))
            enc_ms = cuda_ms_cold(
                torch, lambda: E._mel_encode(engine.model, rows, engine._dtype), iters=5)
        log(f"front end (4 x {seconds:g} s, {wire} wire): log-mel {mel_ms:.4f} ms of "
            f"{enc_ms:.4f} ms for log-mel + encoder ({mel_ms / enc_ms:.2%})")


def prewarm(engine, buckets) -> int:
    """Prewarms ``buckets`` at 1 and 4 rows (the batch buckets a served
    phase's groups reach); returns the graphs captured so far."""
    import torch

    sec = engine.prewarm(buckets, [1, 4])
    log(f"prewarm {'/'.join(f'{b:g}' for b in buckets)} s x 1/4 rows: {sec:.2f} s, "
        f"{engine.graph_captures} decode graphs captured, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    return engine.graph_captures


def graphs_phase(torch, E, W, engine, seconds: float, rows: int, tag: str) -> None:
    """Phase 3c on one prewarmed engine: a group of ``rows`` requests of
    ``seconds`` (alternately a fixed and a detected language) decoded on
    its entry by replaying the captured chunk and by the same chunk
    uncaptured; tokens, lengths and logprob sums must be bitwise identical.
    Prints both ms per decode step (CUDA events)."""
    from stt_tpu_torch import bench as B

    bucket = engine._bucket_for(int(seconds * 16000))
    n = int(bucket * 16000)
    pcm = np.zeros((rows, n), np.int16)
    for i in range(rows):
        audio = synth_audio(seconds * (0.6 + 0.4 * i / max(1, rows - 1)), seed=40 + i)
        pcm[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    prompt = np.array([W.build_prompt(engine.config, "en")] * rows, np.int64)
    auto = np.arange(rows) % 2 == 1
    max_new = engine._max_new_for(bucket)
    dev = engine.device
    with engine._device_lock, torch.inference_mode():
        rows_dev = torch.from_numpy(E._encode_wire_rows(pcm, engine.audio_wire)).to(dev)
        enc = E._mel_encode(engine.model, rows_dev, engine._dtype)
        entry = engine.graphs.lookup(bucket, rows, prompt.shape[1], max_new)
        ckv = W.precompute_cross_kv(engine.model.decoder, enc, out=entry.cross_kv)
        prompt_dev, _, _ = E._detect_and_patch_lang(
            engine.model, enc, torch.from_numpy(prompt).to(dev), torch.from_numpy(auto).to(dev),
            ckv, 1)
        plen = torch.full((rows,), prompt.shape[1], dtype=torch.long, device=dev)
        got = {captured: engine.graphs.decode(entry, prompt_dev, plen, captured=captured)
               for captured in (True, False)}
        torch.cuda.synchronize()
    a, b = got[True], got[False]
    for name in ("tokens", "lengths", "sum_logprob"):
        x, y = getattr(a, name), getattr(b, name)
        if not torch.equal(x, y):
            fail(f"decode graphs ({tag}): captured and uncaptured {name} differ: "
                 f"{x.tolist()} vs {y.tolist()}")
    ms = {c: B.decode_step_ms(engine, bucket, rows, captured=c) for c in (True, False)}
    nbytes = B.decode_step_bytes(engine, bucket, rows)
    bound_ms = nbytes / H100_HBM_BYTES * 1e3
    log(f"decode graphs ({tag}, {rows} x {bucket:g} s, max_new {max_new}, "
        f"{entry.launches['xattn_decode']} xattn_decode launches a chunk): captured and "
        f"uncaptured tokens, lengths and logprob sums bitwise identical (lengths "
        f"{a.lengths.tolist()}); ms per decode step: captured {ms[True]:.4f}, uncaptured "
        f"{ms[False]:.4f}; {nbytes / 1e6:.1f} MB a step, bound {bound_ms:.4f} ms (bytes), "
        f"captured at {bound_ms / ms[True]:.1%} of it")


def serve_default_phase(torch, E, W, audio_wire: str) -> int:
    """Phase 3a: whisper-small bf16 on the default attention path (int8
    cross K/V, einsum attention), 8 concurrent requests of 1-10 s on the
    given audio wire, after a prewarm of their shapes. Checks that every
    log-mel launch of the run received rows of the wire's type and that no
    decode graph was captured while serving; on the mu-law wire it then
    holds the captured decode against the uncaptured one (phase 3c).
    Returns the log-mel launch count."""
    from stt_tpu_torch.ops.kernels.mel import mel_logspec

    t0 = time.monotonic()
    engine = E.WhisperEngine(
        "small", device="cuda", compute_type="bfloat16",
        batch_buckets=(1, 4, 16, 64), batch_window_ms=50.0, max_decode_tokens=224,
        cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off",
        audio_wire=audio_wire,
    )
    cfg = engine.config
    if engine.audio_wire != audio_wire:
        fail(f"engine built with audio_wire={audio_wire!r} serves {engine.audio_wire!r}")
    log(f"engine ({audio_wire} wire): whisper-{cfg.name} bf16 d={cfg.n_text_state} layers "
        f"{cfg.n_audio_layer}+{cfg.n_text_layer} heads {cfg.n_text_head} vocab "
        f"{cfg.n_vocab}; built in {time.monotonic() - t0:.1f} s")
    wire_dtype = {"mulaw": torch.uint8, "int16": torch.int16}[audio_wire]
    real = E.mel_logspec
    row_dtypes = []

    def recorded(rows, *args, **kwargs):
        row_dtypes.append(rows.dtype)
        return real(rows, *args, **kwargs)

    try:
        # first call pays cuBLAS/cuDNN set-up; not part of the measured run
        t0 = time.monotonic()
        engine.transcribe_sync(E.DecodeRequest(synth_audio(1.0, 9), language="en"))
        log(f"warm-up request: {time.monotonic() - t0:.2f} s")
        captures = prewarm(engine, [1.0, 2.0, 5.0, 10.0])

        durations = [1.0, 2.0, 5.0, 10.0] * 2
        requests = [
            E.DecodeRequest(synth_audio(d, seed=i), language=None if i % 2 else "en",
                            session_id=f"smoke-{audio_wire}-{i}", is_final=True)
            for i, d in enumerate(durations)
        ]
        E.mel_logspec = recorded
        mel_logspec.launches = 0
        results, wall = serve_concurrently(engine, requests)
        launches = mel_logspec.launches
        served_captures = engine.graph_captures - captures
        check_served(E, W, engine, requests, results)
    finally:
        E.mel_logspec = real
        engine.close()
    if served_captures:
        fail(f"{audio_wire} wire: {served_captures} decode graphs captured while serving "
             f"prewarmed shapes")
    if engine._thread is not None or engine._harvest_thread is not None:
        fail("engine threads still running after close()")
    if launches <= 0:
        fail("the served path never launched the mel kernel")
    if len(row_dtypes) != launches or set(row_dtypes) != {wire_dtype}:
        fail(f"{audio_wire} wire: the log-mel kernel got rows {row_dtypes} in {launches} "
             f"launches, not {wire_dtype}")
    log(f"served {len(requests)} requests on the {audio_wire} wire in {wall:.3f} s; "
        f"mel_logspec launches {launches}, each on {wire_dtype} rows; no decode graph "
        f"captured while serving ({engine.graph_replays} replays so far)")
    front_end_share(torch, E, engine, (1.0, 2.0, 5.0, 10.0), audio_wire)
    if audio_wire == "mulaw":
        graphs_phase(torch, E, W, engine, 10.0, 4, "whisper-small bf16, int8 cross K/V, einsum")
    return launches


def serve_30s_phase(torch, E, W):
    """Phase 3b: whisper-small bf16 with fp8 cross K/V and both attention
    kernels on, 4 concurrent requests in the 30 s bucket, after a prewarm
    of their shapes. Returns the launch counts of the run: a kernel launched
    inside a captured decode chunk counts the launches the capture recorded
    times the chunk's replays, and the decoder steps are the uncaptured
    ones (language detection) plus ``FINISH_CHECK_EVERY`` a replay. Then
    holds the captured decode against the uncaptured one (phase 3c)."""
    from stt_tpu_torch.ops.kernels.flash_attention import flash_attention
    from stt_tpu_torch.ops.kernels.mel import mel_logspec
    from stt_tpu_torch.ops.kernels.xattn_decode import xattn_decode

    t0 = time.monotonic()
    engine = E.WhisperEngine(
        "small", device="cuda", compute_type="bfloat16",
        batch_buckets=(1, 4, 16, 64), batch_window_ms=50.0, max_decode_tokens=224,
        cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto",
    )
    cfg = engine.config
    log(f"engine (30 s path): whisper-{cfg.name} bf16, policy {engine.policy}; built in "
        f"{time.monotonic() - t0:.1f} s")
    step = W._decoder_step
    steps = [0]

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    try:
        t0 = time.monotonic()
        engine.transcribe_sync(E.DecodeRequest(synth_audio(30.0, 8), language="en"))
        log(f"warm-up request (30 s): {time.monotonic() - t0:.2f} s")
        captures = prewarm(engine, [30.0])
        durations = [12.0, 20.0, 25.0, 30.0]
        requests = [
            E.DecodeRequest(synth_audio(d, seed=20 + i), language=None if i % 2 else "en",
                            session_id=f"smoke30-{i}", is_final=True)
            for i, d in enumerate(durations)
        ]
        W._decoder_step = counted_step
        steps[0] = 0
        replayed = engine.graphs.replayed_launches()
        replays = engine.graph_replays
        mel_logspec.launches = xattn_decode.launches = flash_attention.launches = 0
        results, wall = serve_concurrently(engine, requests)
        in_graphs = {k: v - replayed[k] for k, v in engine.graphs.replayed_launches().items()}
        counts = {"mel_logspec": mel_logspec.launches + in_graphs["mel_logspec"],
                  "xattn_decode": xattn_decode.launches + in_graphs["xattn_decode"],
                  "flash_attention": flash_attention.launches + in_graphs["flash_attention"],
                  "xattn_decode_in_graphs": in_graphs["xattn_decode"],
                  "graph_replays": engine.graph_replays - replays,
                  "decoder_steps": steps[0] + W.FINISH_CHECK_EVERY * (
                      engine.graph_replays - replays)}
        served_captures = engine.graph_captures - captures
        check_served(E, W, engine, requests, results)
    finally:
        W._decoder_step = step
        engine.close()
    if served_captures:
        fail(f"30 s path: {served_captures} decode graphs captured while serving prewarmed "
             f"shapes")
    if counts["xattn_decode_in_graphs"] <= 0:
        fail("30 s path: no xattn_decode launch inside a replayed decode graph")
    if engine._thread is not None or engine._harvest_thread is not None:
        fail("engine threads still running after close()")
    encodes = counts["mel_logspec"]
    if encodes <= 0 or counts["flash_attention"] != cfg.n_audio_layer * encodes:
        fail(f"30 s path: flash_attention launched {counts['flash_attention']} times for "
             f"{encodes} encodes, not {cfg.n_audio_layer} per encode")
    if counts["decoder_steps"] <= 0 or (
            counts["xattn_decode"] != cfg.n_text_layer * counts["decoder_steps"]):
        fail(f"30 s path: xattn_decode launched {counts['xattn_decode']} times for "
             f"{counts['decoder_steps']} decoder steps, not {cfg.n_text_layer} per step")
    log(f"served {len(requests)} requests (30 s bucket) in {wall:.3f} s; launches {counts}; "
        f"no decode graph captured while serving")
    front_end_share(torch, E, engine, (30.0,), "mulaw")
    graphs_phase(torch, E, W, engine, 30.0, 4, "whisper-small bf16, fp8 cross K/V, both kernels")
    return counts


def graphs_f32_phase(torch, E, W) -> None:
    """Phase 3c for the ``test`` model in float32 on the card."""
    engine = E.WhisperEngine("test", device="cuda", compute_type="float32",
                             batch_buckets=(1, 4, 16, 64))
    prewarm(engine, [10.0])
    graphs_phase(torch, E, W, engine, 10.0, 4, "test model, float32")
    engine.close()


def bench_phase() -> None:
    """Phase 3d: one steady round of the port's bench at 64 x 10 s."""
    from stt_tpu_torch import bench as B

    t0 = time.monotonic()
    result = B.run(B.parse_args(["--rounds", "1"]))
    if result["graph_captures_serving"]:
        fail(f"bench: {result['graph_captures_serving']} decode graphs captured while serving")
    if not (result["value"] > 0 and np.isfinite(result["value"])):
        fail(f"bench: RTFx {result['value']}")
    log(f"bench (one round, {time.monotonic() - t0:.1f} s):")
    log(json.dumps(result))


def load_tool_audio(seconds: float, seed: int) -> bytes:
    """PCM16 of ``tools/bench/grpc_load_test.py``'s synthetic audio (its
    ``synthetic_audio``, seeded per session): a tone with noise and a
    mid-stream silence gap that trips VAD endpointing, ending in speech."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.25 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.normal(0, 1, t.shape)
    gap = int(16000 * min(1.0, seconds * 0.2))
    mid = int(len(sig) * 0.55)
    sig[mid:mid + gap] = 0.0
    return (sig * 32767).astype(np.int16).tobytes()


def grpc_session(grpc, stt_pb2, stt_pb2_grpc, port: int, sid: str, pcm: bytes) -> dict:
    """One streaming session as the load tool runs it: CreateSession with
    partials on and language en, 100 ms chunks at 2x real time, then
    ``is_final``. Returns the client's latencies, the finals and the
    trailing metadata, or the error."""
    out = {"finals": [], "first_partial_s": None, "final_s": None, "error": None}
    step = 1600 * 2
    last_sent = [0.0]
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        stub = stt_pb2_grpc.STTBackendStub(channel)
        try:
            stub.CreateSession(stt_pb2.SessionRequest(
                session_id=sid, attributes={"partial": "true"}, language_code="en"),
                timeout=60)

            def chunks():
                for i in range(0, len(pcm), step):
                    last_sent[0] = time.perf_counter()
                    yield stt_pb2.AudioChunk(session_id=sid, pcm16=pcm[i:i + step],
                                             sample_rate=16000)
                    time.sleep(0.05)
                last_sent[0] = time.perf_counter()
                yield stt_pb2.AudioChunk(session_id=sid, is_final=True, sample_rate=16000)

            start = time.perf_counter()
            call = stub.StreamingRecognize(chunks(), metadata=(("session-id", sid),),
                                           timeout=120)
            for result in call:
                now = time.perf_counter()
                if result.is_final:
                    out["finals"].append(result)
                    out["final_s"] = now - last_sent[0]
                elif out["first_partial_s"] is None:
                    out["first_partial_s"] = now - start
            out["trailing"] = dict(call.trailing_metadata())
        except grpc.RpcError as exc:
            out["error"] = f"{exc.code().name} {exc.details()}"
    return out


def grpc_phase(torch, card: str) -> int:
    """Phase 5: the port's gRPC server in-process, 8 concurrent streaming
    sessions, checked as the docstring says. Returns the log-mel launches
    of the traffic."""
    import tempfile

    import grpc

    from stt_tpu_torch import bench as B
    from stt_tpu_torch.gen import stt_pb2, stt_pb2_grpc
    from stt_tpu_torch.ops.kernels.mel import mel_logspec
    from stt_tpu_torch.server import main as S
    from stt_tpu_torch.server.runtime.runtime import ApplicationRuntime
    from stt_tpu_torch.server.transport.grpc_servicer import STTGrpcServicer

    with tempfile.TemporaryDirectory(prefix="smoke_grpc_") as tmp:
        server_yaml, model_yaml = B.e2e_configs(Path(tmp))
        config = S.configure_from_args(S.parse_args([
            "--config", str(server_yaml), "--model-config", str(model_yaml),
            "--model", "small", "--compute-type", "bfloat16", "--language", "en",
            "--port", "0", "--ws-port", "0"]))
    t0 = time.monotonic()
    server = S.build_grpc_server(config)
    runtime = ApplicationRuntime(config)
    try:
        stt_pb2_grpc.add_STTBackendServicer_to_server(STTGrpcServicer(runtime), server)
        port = S.bind_grpc_port(server, config)
        server.start()
        boot = time.monotonic() - t0
        engine = runtime.model_registry._pools["default"].engines[0]
        shapes = engine.graph_captures
        log(f"grpc: server booted in {boot:.2f} s on port {port} (device {config.device} -> "
            f"{engine.device}, backend {config.model_backend}, whisper-{engine.model_size} "
            f"{engine._dtype}, policy {engine.policy}); {shapes} shapes prewarmed "
            f"({engine.audio_buckets_sec} s x {engine.batch_buckets} rows)")
        n = 8
        sessions = [None] * n

        def run(i: int) -> None:
            sessions[i] = grpc_session(grpc, stt_pb2, stt_pb2_grpc, port, f"smoke-grpc-{i}",
                                       load_tool_audio(5.0, seed=i))

        before = runtime.metrics.render()
        if before["engine_compile_count"] != shapes:
            fail(f"grpc: the engine's metrics hook recorded {before['engine_compile_count']} "
                 f"captures at boot, the engine {shapes}")
        mel_logspec.launches = 0
        threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
        t1 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        wall = time.monotonic() - t1
        launches = mel_logspec.launches
        served_captures = engine.graph_captures - shapes
        after = runtime.metrics.render()
    finally:
        server.stop(5.0).wait()
        runtime.shutdown()
    if any(th.is_alive() for th in threads) or None in sessions:
        fail("grpc: a session did not finish")
    for i, s in enumerate(sessions):
        if s["error"]:
            fail(f"grpc session {i}: ended in {s['error']}")
        if not s["finals"]:
            fail(f"grpc session {i}: no final")
        for r in s["finals"]:
            if not (r.text.strip() and r.language_code == "en"
                    and 0.0 <= r.start_sec <= r.end_sec <= 5.5):
                fail(f"grpc session {i}: bad final {r.text[:40]!r} {r.language_code!r} "
                     f"{r.start_sec}-{r.end_sec}")
        if not float(s["trailing"].get("stt-decode-inference-sec", 0)) > 0:
            fail(f"grpc session {i}: trailing metadata {s['trailing']}")
    if served_captures:
        fail(f"grpc: {served_captures} decode graphs captured while serving")
    if launches <= 0:
        fail("grpc: the served sessions never launched the log-mel kernel")

    def pcts(values):
        return f"p50 {np.percentile(values, 50):.3f} s, p95 {np.percentile(values, 95):.3f} s"

    firsts = [s["first_partial_s"] for s in sessions if s["first_partial_s"] is not None]
    finals = [s["final_s"] for s in sessions]
    # the trailing values are sums over every decode of the session
    medians = {key: float(np.median([float(s["trailing"][f"stt-decode-{key}-sec"])
                                     for s in sessions]))
               for key in ("buffer-wait", "queue-wait", "inference", "response-emit")}
    decodes = float(np.median([int(s["trailing"]["stt-decode-count"]) for s in sessions]))
    groups = after["engine_step_count"] - before["engine_step_count"]
    group_s = (after["engine_step_total"] - before["engine_step_total"]) / max(1, groups)
    rows = (after["engine_batch_rows_total"] - before["engine_batch_rows_total"]) / max(1, groups)
    log(f"grpc: {n} sessions x 5 s at 2x in {wall:.2f} s, every one with a final; "
        f"{launches} log-mel launches, no decode graph captured while serving; "
        f"first partial ({len(firsts)} sessions) {pcts(firsts) if firsts else 'none'}; "
        f"final {pcts(finals)}; trailing medians over finals (sums over a session's "
        f"{decodes:g} decodes): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in medians.items()) + f" ({card})")
    log(f"grpc: per session, first partial (s) "
        f"{[None if s['first_partial_s'] is None else round(s['first_partial_s'], 3) for s in sessions]}"
        f", decodes {[int(s['trailing']['stt-decode-count']) for s in sessions]}; engine: "
        f"{groups} groups of {rows:.2f} rows on average, {group_s:.4f} s a group from its "
        f"device phase to its harvest (max {after['engine_step_max']:.4f} s)")
    return launches


def reference_f32_phase(torch, E, W, dev, clips, flash: str) -> None:
    """Phase 4a: the ``test`` model in float32 on the card against the CPU,
    on ``clips`` of (seconds, language), flash attention ``flash``: encoder
    output and teacher-forced decoder logits within ``REF_ATOL``. With flash
    on at the 30 s bucket the card runs the kernel's float32 body once per
    encoder layer per encode (two encodes here) and the CPU never launches
    it. TF32 stays off in cuBLAS and cuDNN (set in main), so the card's
    matrix products and convolutions are float32 like the CPU's."""
    from stt_tpu_torch.ops.kernels.flash_attention import flash_attention

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the float32 reference would round to ~3 digits")
    reqs = [E.DecodeRequest(synth_audio(s, seed=10 + i), language=lang)
            for i, (s, lang) in enumerate(clips)]
    outs = {}
    for name in ("cuda", "cpu"):
        f0 = flash_attention.launches
        eng = E.WhisperEngine("test", device=name, compute_type="float32",
                              cross_kv_dtype="int8", xattn_kernel="off", flash_attention=flash)
        ctx = eng._device_phase([E._Task(r, None) for r in reqs])
        model = eng.model
        with torch.inference_mode():
            enc = E._mel_encode(model, ctx["rows_dev"], torch.float32)
        outs[name] = (ctx["packed"].cpu().numpy(), enc.cpu(), model)
        eng.close()
        ran = flash_attention.launches - f0
        routed = eng.policy.flash_on(enc.shape[1])
        if flash != "off" and not routed:
            fail(f"float32 reference: {enc.shape[1]} encoder positions never reach flash")
        if ran != (2 * eng.config.n_audio_layer if name == "cuda" and routed else 0):
            fail(f"float32 reference ({flash=}) on {name}: {ran} flash_attention launches")
    enc_err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
    if enc_err > REF_ATOL:
        fail(f"test-model encoder on the card vs CPU ({flash=}): max abs err {enc_err:.3g}")
    tokens = torch.from_numpy(outs["cpu"][0][:, :-5]).long()
    with torch.inference_mode():
        lg_gpu = W.decoder_forward(outs["cuda"][2], tokens.to(dev), outs["cpu"][1].to(dev)).cpu()
        lg_cpu = W.decoder_forward(outs["cpu"][2], tokens, outs["cpu"][1])
    logit_err = (lg_gpu - lg_cpu).abs().max().item()
    if not torch.isfinite(lg_gpu).all() or logit_err > REF_ATOL:
        fail(f"test-model decoder logits on the card vs CPU ({flash=}): max abs err "
             f"{logit_err:.3g}")
    # greedy argmax may flip on a near-tie between two float32 runs, so token
    # identity is reported, and the gate is the teacher-forced logits above
    same_tokens = bool((outs["cuda"][0][:, :-5] == outs["cpu"][0][:, :-5]).all())
    log(f"reference (test model, float32, flash {flash}, "
        f"{'/'.join(f'{s:g}' for s, _ in clips)} s, encoder {outs['cuda'][1].shape[1]} "
        f"positions): encoder max abs err {enc_err:.3g}, teacher-forced logits max abs err "
        f"{logit_err:.3g}, token rows {'identical' if same_tokens else 'differ'} on the card "
        f"and the CPU")


def reference_30s_phase(torch, E, W, dev) -> None:
    """Phase 4b: the ``test`` model in bfloat16 with fp8 cross K/V and both
    attention kernels on, at a 30 s window, on the card against the CPU
    (plain versions): encoder output, then three teacher-forced decode
    steps' logits after the prefill from the CPU's encoder output."""
    from stt_tpu_torch.ops.kernels.flash_attention import flash_attention
    from stt_tpu_torch.ops.kernels.xattn_decode import xattn_decode

    reqs = [E.DecodeRequest(synth_audio(s, seed=30 + i), language=lang)
            for i, (s, lang) in enumerate([(30.0, "en"), (21.0, None)])]
    outs = {}
    for name in ("cuda", "cpu"):
        f0 = flash_attention.launches
        eng = E.WhisperEngine("test", device=name, compute_type="bfloat16",
                              cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto")
        ctx = eng._device_phase([E._Task(r, None) for r in reqs])
        with torch.inference_mode():
            enc = E._mel_encode(eng.model, ctx["rows_dev"], torch.bfloat16)
        outs[name] = (ctx["packed"].cpu().numpy(), enc.cpu(), eng.model, ctx["p_len"])
        eng.close()
        ran = flash_attention.launches - f0
        if ran != (2 * eng.config.n_audio_layer if name == "cuda" else 0):
            fail(f"30 s reference on {name}: {ran} flash_attention launches")
    enc_err = (outs["cuda"][1].float() - outs["cpu"][1].float()).abs().max().item()
    if outs["cuda"][1].shape[1] != 1500 or enc_err > BF16_REF_ATOL:
        fail(f"30 s reference: encoder {tuple(outs['cuda'][1].shape)} on the card vs CPU, "
             f"max abs err {enc_err:.3g}")
    packed, enc_cpu, _, p_len = outs["cpu"]
    tokens = torch.from_numpy(packed[:, : p_len + 2]).long()

    def step_logits(model, device):
        dec = model.decoder
        enc = enc_cpu.to(device)
        toks = tokens.to(device)
        with torch.inference_mode():
            ckv = W.precompute_cross_kv(dec, enc)
            cache = W.init_kv_cache(model.config, toks.shape[0], p_len + 2, torch.bfloat16,
                                    device)
            W._prefill_parallel(dec, toks, p_len - 1, cache, ckv)
            return torch.stack([W._decoder_step(dec, toks[:, pos], pos, cache, ckv).cpu()
                                for pos in range(p_len - 1, p_len + 2)])

    x0, f0 = xattn_decode.launches, flash_attention.launches
    lg_gpu = step_logits(outs["cuda"][2], dev)
    if xattn_decode.launches - x0 != 3 * outs["cuda"][2].config.n_text_layer:
        fail("30 s reference: the card's decode steps did not launch xattn_decode")
    lg_cpu = step_logits(outs["cpu"][2], torch.device("cpu"))
    if xattn_decode.launches != x0 + 3 * outs["cuda"][2].config.n_text_layer \
            or flash_attention.launches != f0:
        fail("30 s reference: the CPU run launched a kernel")
    logit_err = (lg_gpu - lg_cpu).abs().max().item()
    if not torch.isfinite(lg_gpu).all() or logit_err > BF16_LOGITS_ATOL:
        fail(f"30 s reference: decode-step logits on the card vs CPU, max abs err "
             f"{logit_err:.3g}")
    same_tokens = bool((outs["cuda"][0][:, :-5] == outs["cpu"][0][:, :-5]).all())
    log(f"reference (test model, bf16, fp8 cross K/V, both attention kernels, 30 s): encoder "
        f"max abs err {enc_err:.3g}, 3 decode steps' logits max abs err {logit_err:.3g} "
        f"(|logits| up to {lg_cpu.abs().max().item():.3g}), token rows "
        f"{'identical' if same_tokens else 'differ'} on the card and the CPU")


def main() -> None:
    faulthandler.dump_traceback_later(WATCHDOG_SEC, exit=True)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import stt_tpu_torch
    except ImportError as exc:
        fail(f"stt_tpu_torch is not beside this script ({exc}); run it from a checkout")
    if Path(stt_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"stt_tpu_torch imported from {stt_tpu_torch.__file__}, not from {ROOT}")
    from stt_tpu_torch.engine import engine as E
    from stt_tpu_torch.models import whisper as W
    from stt_tpu_torch.ops import mel as M
    from stt_tpu_torch.ops.cuda import build
    from stt_tpu_torch.ops.kernels.mel import log_mel_spectrogram_plain, mel_logspec

    # plain versions and the float32 reference are full float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # -- 1. build --------------------------------------------------------------
    seconds = build.load_many(KERNELS)
    log(f"build: {', '.join(f'{n}.cu {s:.1f} s' for n, s in seconds.items())} "
        f"(with {build.find_nvcc()}, in parallel)")
    for name, report in build.REPORTS.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                usage = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 5]
                         if "Used" in x or "stack frame" in x]
                log(f"ptxas {name}.cu {entry}: {'; '.join(usage)}")

    # -- 2. kernel vs plain ----------------------------------------------------
    def rows_for(wire: str, batch: int, seconds: float) -> torch.Tensor:
        audio = np.stack([synth_audio(seconds, seed=i) for i in range(batch)])
        if wire == "silence":
            audio = np.zeros_like(audio)
        pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        host = {"float32": audio, "int16": pcm}.get(wire)
        if host is None:  # mu-law, as the engine sends it (silence included)
            host = E._encode_wire_rows(pcm, "mulaw")
        return torch.from_numpy(np.ascontiguousarray(host)).to(dev)

    hann = torch.hann_window(M.N_FFT, device=dev)
    filterbanks = {n: torch.from_numpy(M.mel_filterbank(n)).to(dev) for n in (80, 128)}

    def library_logmel(rows: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
        """The same function through torch.stft and a filterbank matmul, its
        constants already on the card."""
        audio = M.expand_wire(rows)
        spec = torch.stft(audio, M.N_FFT, M.HOP_LENGTH, window=hann, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec[..., :-1].abs() ** 2
        return torch.log10(torch.clamp_min(filterbanks[n_mels] @ power, 1e-10))

    def mel_bound_ms(rows: torch.Tensor, n_mels: int = 80):
        """Least time for the function's own work: a 400-point real FFT per
        frame (2.5 N log2 N flops), the window, the power, the filterbank's
        non-zeros and the log; each input byte read once, each output byte
        written once. The filterbank (a few KB of constants) is not counted."""
        b, t = rows.shape
        frames = b * (t // M.HOP_LENGTH)
        n_bins = M.N_FFT // 2 + 1
        nonzeros = int(np.count_nonzero(M.mel_filterbank(n_mels)))
        per_frame = (2.5 * M.N_FFT * np.log2(M.N_FFT) + M.N_FFT + 3 * n_bins
                     + 2 * nonzeros + n_mels)
        nbytes = rows.numel() * rows.element_size() + frames * n_mels * 4
        t_ops, t_bytes = frames * per_frame / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    # (batch, seconds, wire, n_mels): 1 row of 1 s to 16 rows of 10 s and 4 of
    # 30 s (phase 3b's encode) on every wire; the groups phase 3a forms (2
    # requests padded to the batch bucket of 4 rows at each of the 1/2/5/10 s
    # buckets) on both served wires; 128 mels (large-v3) at 16 x 10 s; frame
    # counts that are not a multiple of the kernel's 16-frame tile
    shapes = [(1, 1.0), (3, 5.0), (16, 10.0), (4, 30.0)]
    cases = [(b, s, w, 80) for b, s in shapes for w in ("silence", "float32", "int16", "mulaw")]
    cases += [(4, s, w, 80) for s in (1.0, 2.0, 5.0, 10.0) for w in ("mulaw", "int16")]
    cases += [(16, 10.0, w, 128) for w in ("mulaw", "int16")]
    cases += [(3, 1.5, "int16", 80), (2, 0.17, "mulaw", 128)]
    mel_err = {}
    headline = None
    for batch, seconds, wire, n_mels in cases:
        rows = rows_for(wire, batch, seconds)
        got = M.normalize_log_mel(mel_logspec(rows, n_mels))
        ref = M.normalize_log_mel(log_mel_spectrogram_plain(rows, n_mels))
        torch.cuda.synchronize()
        tag = f"mel_logspec {batch}x{seconds:g}s {wire} {n_mels} mels"
        if (got.shape != (batch, n_mels, rows.shape[1] // M.HOP_LENGTH)
                or not torch.isfinite(got).all()):
            fail(f"{tag}: shape {tuple(got.shape)} or non-finite values")
        err = (got - ref).abs().max().item()
        mel_err[wire] = max(mel_err.get(wire, 0.0), err)
        used = limit_used(got, ref, MEL_ATOL, MEL_RTOL)
        try:
            torch.testing.assert_close(got, ref, atol=MEL_ATOL, rtol=MEL_RTOL)
        except AssertionError as exc:
            fail(f"{tag}: kernel disagrees with plain: {exc}")
        runs = {"kernel": lambda: mel_logspec(rows, n_mels),
                "plain": lambda: log_mel_spectrogram_plain(rows, n_mels),
                "library": lambda: library_logmel(rows, n_mels)}
        cold, warm, notes = {}, {}, {}
        for name, fn in runs.items():
            report = {}
            cold[name] = cuda_ms_cold(torch, fn, report=report)
            warm[name] = cuda_ms(torch, fn)
            notes[name] = f"enqueue {report['enqueue_ms']:.3f} ms"
            if report["spin_ms"] > spin_ms(torch, SPIN_CYCLES) * 1.01:
                notes[name] += f", spin lengthened to {report['spin_ms']:.3f} ms"
            if report["in_loop_ms"] >= report["spin_ms"]:
                notes[name] += (f", waits on the device ({report['in_loop_ms']:.3f} ms "
                                f"enqueued after the spin): host time in the reading")
        b_ms, b_by = mel_bound_ms(rows, n_mels)
        lib = M.normalize_log_mel(library_logmel(rows, n_mels))
        lib_err = (lib - ref).abs().max().item()
        log(f"{tag}: max_abs_err {err:.3g}, {used:.3g} of the limit (library {lib_err:.3g}); "
            f"cold: " + ", ".join(f"{n} {cold[n]:.4f} ms ({notes[n]})" for n in runs)
            + "; back to back: " + ", ".join(f"{n} {warm[n]:.4f} ms" for n in runs)
            + f"; bound {b_ms:.3g} ms ({b_by}), {b_ms / cold['kernel']:.1%} of the bound")
        if (batch, seconds, wire, n_mels) == (16, 10.0, "mulaw", 80):
            headline = dict(ms=cold["kernel"], plain_ms=cold["plain"],
                            library_ms=cold["library"], bound_ms=b_ms, bound_by=b_by,
                            ms_back_to_back=warm["kernel"])
    log("mel_logspec largest error per wire: "
        + ", ".join(f"{w} {e:.3g}" for w, e in mel_err.items()))

    xattn_err, xattn_headline = xattn_phase(torch, dev)
    flash_err, flash_headline, flash32_headline = flash_phase(torch, dev)

    # -- 3a. served requests, default path (int8 cross K/V, einsum attention) ---
    launches = serve_default_phase(torch, E, W, "mulaw")
    serve_default_phase(torch, E, W, "int16")

    # -- 3b. served requests, 30 s path (fp8 cross K/V, both attention kernels) -
    counts_30s = serve_30s_phase(torch, E, W)

    # -- 3c. decode graphs in float32; 3d. one round of the port's bench --------
    graphs_f32_phase(torch, E, W)
    bench_phase()

    # -- 5. the gRPC streaming path (before 4: the server's engine is shut down first)
    grpc_phase(torch, card)

    # -- 4. reference on small inputs -------------------------------------------
    reference_f32_phase(torch, E, W, dev, [(1.5, "en"), (0.7, None)], flash="off")
    reference_f32_phase(torch, E, W, dev, [(30.0, "en"), (24.0, None)], flash="auto")
    reference_30s_phase(torch, E, W, dev)

    # -- 6. result -------------------------------------------------------------
    kernels = [{
        "name": "mel_logspec",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/mel.cu",
        "replaces": "stt_tpu/ops/pallas/mel.py:84",
        "launches": launches,
        "max_abs_err": max(mel_err.values()),
        **headline,
    }, {
        "name": "xattn_decode",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/xattn_decode.cu",
        "replaces": "stt_tpu/ops/pallas/xattn_decode.py:186",
        "launches": counts_30s["xattn_decode"],
        "max_abs_err": xattn_err,
        **xattn_headline,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention.cu",
        "replaces": "stt_tpu/models/whisper.py:378",
        "launches": counts_30s["flash_attention"],
        "max_abs_err": flash_err,
        **flash_headline,
        "float32": flash32_headline,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
