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
   float32 K/V (atol 1e-3, rtol 1e-2), the default path's two int8-code
   cross-attention products (atol 1e-4, rtol 1e-5; 1/4/16/64 rows x 250
   and 1500 keys x 12 and 20 heads; the library call is the widening
   route they replace, the codes copied to bf16 before the product) and
   encoder flash attention (bf16
   body atol 2e-3, rtol 1e-2; float32 body atol 1e-5, rtol 1e-5), each
   case printing the share of its limit used and the kernel's share of its
   bound; the cross-attention decode cases cover every cluster size the
   split planner picks (1, 2, 4, 8 and 16 blocks) and Ta above the
   one-block cap of earlier versions; the float32 flash cases include the
   served 1/4/16/64 rows x 12 heads x 1500, each naming its key split and
   the grid's waves, and at 1 and 4 rows every key split is timed too; the
   cross-attention decode also runs, in fp8 and int8 over 1500 keys, every
   row count the shipped matrix serves (each batch bucket of
   ``config/server.yaml`` times each beam width of ``config/model.yaml``'s
   profiles, so the beam path's rows x beam rows too).
   Every time is read with the L2 cache flushed and the device spinning
   until the host has enqueued the call (``cuda_ms_cold``); log-mel also
   prints each call's host enqueue time and, in a second column, the
   back-to-back reading of earlier versions;
   then (2b) holds the model's products with narrow operands and float32
   accumulation, the route the card takes (``bmm``/``mm`` with
   ``out_dtype=float32``), against the float32 route (operands upcast,
   the CPU's route) on the same inputs at the served decode's shapes (4
   and 64 rows x 10 s: self-attention over 84 cache slots, cross attention
   over 500 int8 positions with their scales, which takes the int8-code
   products, the 51865 x 768 logits) and the 10 s encode's (500 x 500),
   attention atol 1e-3 / rtol 1e-2, logits 1e-4 / 1e-4, and times both
   routes, each line naming the card's route;
3. serves two paths with whisper-small in bfloat16 at full width and
   random weights from seed 0, each with the launch counts set to 0 just
   before and read just after:
   a. the default path (int8 cross K/V, einsum attention): 8 concurrent
      requests of 1, 2, 5 and 10 s of synthetic audio from 8 threads, on
      the default mu-law wire and again with ``audio_wire="int16"``, each
      checking the row type every log-mel launch received and that each
      int8-code product launched once per decoder layer per decoder step;
   b. the 30 s path (fp8 cross K/V, ``xattn_kernel="mm"``,
      ``flash_attention="auto"``): 4 concurrent requests of 12, 20, 25 and
      30 s, all in the 30 s bucket, the only one whose 1500 encoder
      positions reach flash attention's 512; then the same audio as two
      ticks of drafted partials (``draft_mode="on"``), whose resume steps
      run the cross-attention kernel inside the drafted entry's graph;
   each engine first prewarms the shapes its requests reach (every bucket
   of the path at 1 and 4 rows, on path b with the drafted entries), which
   captures their decode graphs, and
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
   e. beam search, the shipped ``accurate`` profile (beam 5, patience 1),
   on two engines: int8 cross K/V with einsum attention (4 requests of
   6-10 s, one 10 s bucket), and fp8 cross K/V with both attention
   kernels (4 requests of 12-30 s, the 30 s bucket); each engine first
   prewarms its bucket at beam 5 (1 and 4 rows; 64 too on the int8 one),
   and the phase fails if a graph is captured while the requests are
   served; it checks every output and counts the launches as 3b does (on
   the 30 s engine flash once per encoder layer per encode, cross-attention
   decode once per decoder layer per step over the rows x beams rows); then
   one group of 4 decoded on its beam entry by replaying the captured
   chunk, by the same chunk uncaptured (tokens, lengths and logprob sums
   bitwise identical) and by the uncaptured ``beam_decode`` (tokens and
   lengths identical); and the ms per beam step, captured and eager,
   beside the step's bound (the bytes it needs: the cross K/V once a row,
   the self cache once) and beside the bytes this design moves (the cross
   K/V once a beam, the self cache once more for the reorder by parent
   beam) at 4 rows, and at 64 rows of 10 s;
   g. the decode routes (after e): whisper-small bf16 with ``draft_mode="on"``
      on the default path (4 and 64 rows x 10 s) and the fp8 path with both
      kernels (4 rows x 30 s), each engine first prewarming its plain
      entries at beams 1 and 5, then one group a route: a 32-token
      conditioning prompt (the streaming ``_cond_ctx`` one) greedy and as
      two ticks of drafted partials, ``prefix``, ``repetition_penalty``
      1.3 with ``no_repeat_ngram_size`` 3 greedy and at beam 5, the
      ladder ``[0.0, 0.2, 0.4]`` with ``best_of`` 5 and
      ``log_prob_threshold`` 0 (every random-weight row falls back),
      timestamps greedy and at beam 5, and clip ranges. A route's entries
      are captured at first use. It checks every output (timestamp
      grammar, the prefix leading the text, every ladder row resampled, the
      prompt's width), the launch counts as 3b does (log-mel once a group
      and once more for the ladder's re-encode, flash and
      ``xattn_decode`` on the fp8 path), at 4 rows each route's first
      decode replayed and run uncaptured (bitwise equal: tokens, lengths,
      logprob sums, accepted counts), two sampled decodes at one seed
      equal and at two seeds different; it prints each route's group time
      and captures, a second full ladder's group time, each route's ms
      per step captured and eager beside the greedy step at 64 x 10 s,
      and the memory reserved. Then the ``test`` model in float32 on the
      card against the CPU on every route (2 requests), the ladder's
      draws from an integer hash both devices compute alike: tokens,
      temperatures and texts equal; and greedy timestamp decodes of the
      ``test`` model in bf16 on the card and the CPU, each row that differs
      printed with the card's top-2 gap (or the sum-probability rule's
      margin) at its first difference, failing above 0.05 (not a tie);
   h. long finals, word timestamps and checkpoints (after g): on the
      default path, a 75 s final (two 30 s windows and a 15 s tail,
      conditioned on the text so far) submitted beside 4 partials of 5 s
      from other sessions, which must resolve before it; each window where
      the seek loop's rule puts it and the final's segments the windows'
      shifted to global, monotone times; its window count, wall time, the
      entries its conditioned windows captured while serving and the
      memory reserved printed. Then word timestamps on 64 rows of 6-10 s
      (every row with text has words, monotone inside its duration; the
      pass's time and device memory printed); then the seed-0 weights
      written as a bf16 HF checkpoint with the port's writer and an engine
      built from ``weights_path`` (``STT_ALLOW_FALLBACK_TOKENIZER=1``),
      whose greedy tokens at 4 x 10 s must be the seeded engine's (write
      and load seconds and the file's bytes printed). On the fp8 path with
      both kernels, the same final in timestamp mode (the seek checked by
      segment, flash launched once per encoder layer per window,
      ``xattn_decode`` once per decoder layer per step) and words on 4
      rows of 24-30 s. Last the ``test`` model in float32 on the card
      against the CPU: a 65 s final in timestamp mode with words, its
      segments equal, its words equal in text with times within 0.02 s
      (one frame);
   i. the decoder policies, any decode bound and ``use_pallas=False``
      (after h): the default whisper-small bf16 engine (int8 cross K/V,
      einsum) serves 64 x 10 s greedy and 4 x 10 s at beam 5; an engine at
      ``use_pallas=False`` serves a 16 x 10 s group with no log-mel kernel
      launch where the default engine launches it once, its plain log-mel
      within the kernel's tolerance (atol 2e-4, rtol 1e-4); then one engine
      per policy switch (``STT_DECODER_WEIGHTS_DTYPE`` int8 and int8_native,
      ``STT_FUSED_QKV``, ``STT_SELF_KV_DTYPE=fp8``, ``STT_PREFILL=seq``, and
      fused with int8) serves the same two groups with no capture, its
      greedy (64 rows) and beam-5 (4 rows) replays bitwise their uncaptured
      runs, one decode step's logits within 0.05 of the same policy's model
      on the CPU (plain versions, 8 rows of the card's encoder output; 0.1
      for int8_native, which re-quantizes every activation), and against
      the default engine's within 0.05 for fused and seq and within the JAX
      package's own bars for 8-bit storage (0.06 of the largest |logit| for
      int8 weights and the fp8 self cache, 0.12 for int8_native,
      ``tests/test_quant_weights.py``), the greedy token agreement printed
      beside it (every policy is measured before the phase fails on any),
      and prints its
      captured greedy and beam-5 steps beside the default engine's, its
      decoder's bytes on the card and, for seq, a conditioned 30 s window's
      prefill (228 tokens); then an engine at ``max_decode_tokens=100``
      serves 4 x 30 s greedy, at beam 5 and as two drafted ticks, no row
      past 100, the 30 s entries' replays (12 chunks and a captured tail of
      4) bitwise their uncaptured runs. The ``test`` model in float32 on
      the card gives the CPU's tokens at ``use_pallas=False``, under fused
      and seq (greedy, beam 5, drafted) and at the bound 100;
   j. opt-in VAD (after i): the batched VAD scorer on the card at 64
      sessions x 3 frames (probabilities within 1e-5 of the numpy path; ms
      per tick idle and right behind ~60 ms of products queued on the
      default stream, on the scorer's own stream and, for comparison, on
      the default stream); a graph with the Silero v5 signature (input
      [B, 576], state [2, B, 128], sr), hand-encoded with seeded weights,
      scoring 30 frames on the card within 1e-5 of the port's executor on
      the CPU (ms per 3-frame chunk); then the gRPC server in-process with
      ``vad.device: device`` and again with host VAD (batch bucket 16 only,
      drafting off), 16 sessions of the load tool's audio at 2x with
      partials on and a final at each VAD endpoint: the scorer's batches
      above 0 and its fallbacks 0, every session's finals (endpoints and
      texts) equal with both, first-partial and final p95 of each; a JSON
      line summarises phases i and j;
   k. training and the (data, model) mesh (after j): (a) the flash
      backward kernels (dK/dV, dQ) and the forward's log-sum-exp at 4 x 12
      x 1500 x 64 in float32 and bf16 against their plain versions (lse
      within 1e-3; gradients within 1e-4 of the largest |gradient| in
      float32, 2e-2 in bf16; the library's backward's distance printed as
      an independent check), a second call of each bit-identical to the
      first, the count of HGMMA instructions in each bf16 body's SASS
      (``cuobjdump -sass``; none fails), each timed cold beside its plain
      version, its bound (and its share of it) and the library's backward
      (autograd through SDPA; timed three times, min and max printed; each
      kernel's ratio to it), and the served forward timed with and without
      the log-sum-exp; (b) whisper-small float32 trained at a (1, 1) mesh
      with flash on, 4 rows of a 30 s mel and 128 random tokens a row: 5
      steps, losses finite and falling, ms a step, peak memory, the
      forward, dK/dV and dQ kernels launched 12 times each a step (counts
      set to 0 before each step), the first step's gradients within 1e-4 of
      each leaf's largest |gradient| (and its loss within 1e-5) of the same
      step with flash off; then the same with bf16 parameters, 3 steps (the
      bf16 bodies, 12 launches each a step, losses finite, ms a step, peak
      memory, step 1's loss within 1e-2 relative of flash off's);
      (c) two gloo ranks on cuda:0 at (2, 1) and (1, 2), their first loss
      and full gradients and their second loss against (b)'s at the same
      bars; (d) the engine at a (1, 2) mesh with both slots on cuda:0:
      float32 at 4 x 10 s with the single engine's tokens, bf16 at 64 x 10 s
      with its captured greedy step beside the single engine's and the
      token agreement, then the ``test`` model's serving, drafted and
      registry proofs of ``stt_tpu_torch/parallel/dryrun.py``; (e) a
      checkpoint after (b)'s step 2 restored into a fresh trainer, whose
      step 3 loss must be bitwise (b)'s, and restored at (1, 2) within 1e-5;
   f. drafted partials (run before e): the ``test`` model in float32 on the
   card, 4 rows of 5 s with an empty, a perfect, an adversarial and a
   mid-mutation draft, must give the plain decode's tokens and lengths,
   accepted counts equal to each draft's common prefix with the plain
   tokens, and captured resume replays bitwise the uncaptured chunk; then
   whisper-small bf16 on the default path in the 5 s bucket (the partial
   window), at 4 and 64 rows: plain, drafted with the plain decode's own
   tokens as drafts and at acceptance 0 (a draft greedy never writes),
   each row where a drafted decode's tokens differ from the plain ones
   printed with the plain decode's top-2 logit gap at the first difference
   (above 0.05 fails: not a tie); the decode times (CUDA events) of those,
   of drafts every row accepts whole (acceptance 1) and of the verify pass
   alone, and the break-even acceptance beside ``STT_DRAFT_ENGAGE``; then
   3 ticks of 64 sessions under
   ``draft_mode="on"`` and again under ``"adaptive"``, each engine
   prewarmed with its drafted entries, failing if a graph is captured
   while serving;
4. checks the outputs against references on small inputs: the ``test``
   model in float32 on the card against the CPU (encoder output and
   teacher-forced logits within max abs 1e-3), once at 1.5 s with flash
   off and once at a 30 s window with flash on (the kernel's float32 body,
   launched once per encoder layer), with TF32 off in cuBLAS and cuDNN;
   and in bfloat16 with fp8 cross K/V and both attention kernels on, at a
   30 s window, against the same model on the CPU through the plain
   versions (encoder output within max abs 0.05, three teacher-forced
   decode steps' logits within 1e-2);
5. serves the gRPC streaming path, the HTTP plane and the WebSocket
   bridge (run after 3d, before 4's references): the port's server built
   in-process with the calls ``serve()`` makes (``ApplicationRuntime``,
   ``build_grpc_server``, ``STTGrpcServicer``, ``bind_grpc_port``,
   ``start_http_server`` and, when ``websockets`` imports,
   ``start_ws_server``; else one line says the bridge was not started)
   from the shipped YAML files with the shape matrix
   narrowed as the bench's end-to-end phase narrows it (audio buckets 5
   and 10 s, batch buckets 1 and 16, max batch 16) but the ``accurate``
   profile kept, so the boot prewarms beams 1 and 5, whisper-small bf16 on
   the shipped attention policy and the shipped drafting mode (adaptive:
   the boot prewarms the drafted entries too), language en; 8 concurrent
   sessions through the port's own stubs, each streaming
   5 s of the load tool's synthetic audio (tone bursts with a mid-stream
   silence gap, ending in speech) in 100 ms chunks at 2x real time with
   partials on, then ``is_final``. It fails unless every session gets a
   final with text, language en and ``0 <= start <= end <= 5.5``, a
   trailing ``stt-decode-inference-sec`` above 0 and no error status, no
   decode graph was captured after boot, and the log-mel kernel was
   launched (its count set to 0 just before the traffic). It prints the
   boot time, the shapes prewarmed (the drafted ones among them), the
   ``draft_*`` counters of ``/metrics`` after the sessions, the client's
   first-partial and final
   latency p50/p95 and the medians of the four trailing
   ``stt-decode-*-sec`` values over the finals. On the HTTP plane it
   requires ``/health`` to answer 500 before the gRPC server starts (the
   model loaded and every shape prewarmed) and 200 after; ``/metrics`` and
   ``/metrics.json`` to carry the engine's counters as the runtime holds
   them; ``/system`` with ``STT_ENABLE_TPU_METRICS=1`` to name the card;
   a REST transcription of 5 s (realtime profile) to answer 200 with text
   and segments and launch the log-mel kernel; and one WS session to end
   in ``done`` with a final that has text. Then ``accurate`` three ways:
   one gRPC session with ``DECODE_PROFILE_ACCURATE`` (as above, every
   final with text), one REST transcription naming no profile (200 with
   text) and one ``python3 -m stt_tpu_torch.client.batch_file`` run on the
   bundled clip (``accurate`` by default; exit 0 and a final with text),
   each timed, with no decode graph captured. Then it stops the planes;
6. closes the engines, then prints one JSON line describing each kernel
   body (log-mel, cross-attention decode, flash attention's bf16 and
   float32 bodies, whose launches include 3k (b)'s, and the flash
   backward's dK/dV and dQ kernels in float32 and in bf16, whose launches
   are those of 3k (b)'s float32 5 steps and bf16 3 steps and whose
   numbers are 3k (a)'s at 4 x 12 x 1500) and, last,
   ``{"ok": true, "device": {...}}``.

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
WATCHDOG_SEC = 1100
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
# the int8-code products form the plain versions' exact float32 products
# (a bf16 value, or a weight rounded to bf16, times an int8 code) and sum
# them in another order (tests/test_torch_kernels_cuda.py)
CROSS_ATOL, CROSS_RTOL = 1e-4, 1e-5
# narrow operands vs the float32 route: both multiply the same bf16 values,
# exactly in float32, and sum in float32 in another order (a few ulps); the
# attention weights round to bf16 on both routes, so a weight whose float32
# value falls on the other side of a rounding step moves the output by one
# bf16 step of that weight, as for xattn_decode
NARROW_ATTN_TOL = (XATTN_ATOL, XATTN_RTOL)
NARROW_LOGITS_TOL = (1e-4, 1e-4)         # logits |x| < ~3, sums of 768 terms
BF16_REF_ATOL = 0.05                     # encoder, tests/test_torch_whisper.py:31
BF16_LOGITS_ATOL = 1e-2                  # decode-step logits, |logits| < 1 here
# a drafted row may differ from the plain decode in bf16 only at a near-tie
# of the plain decode's top two logits (the verify pass's M=width products
# sum in another order than the step's M=1): the bf16 logits limit
BF16_TIE_GAP = 0.05
H100_F32_FLOPS = 67e12                   # CUDA-core float32 peak, SXM, 700 W
H100_BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak, SXM, 700 W
H100_HBM_BYTES = 3.35e12                 # HBM3 bytes/s
L2_FLUSH_BYTES = 256 * 1024 * 1024       # > the 50 MB L2: a cold cache per timed call
SPIN_CYCLES = 1_000_000                  # device spin after each flush, ~0.5 ms
KERNELS = ("mel", "cross_mm", "xattn_decode", "flash_attention", "flash_attention_bwd")
BEAM = 5
# config/model.yaml's accurate profile, as the server passes it to a decode
ACCURATE = {"beam_size": BEAM, "best_of": 5, "patience": 1.0, "temperature": 0.0,
            "length_penalty": 1.0, "without_timestamps": True,
            "compression_ratio_threshold": 2.4, "no_speech_threshold": 0.6,
            "log_prob_threshold": -1.0}


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


def served_decode_rows() -> list:
    """Decoder rows of every served shape: each batch bucket of the shipped
    ``config/server.yaml`` times each beam width of the shipped
    ``config/model.yaml`` profiles (1 and 5: 1, 4, 16, 64, 5, 20, 80, 320)."""
    import yaml

    from stt_tpu_torch.config.loader import DEFAULT_CONFIG_PATH, DEFAULT_MODEL_CONFIG_PATH

    buckets = yaml.safe_load(DEFAULT_CONFIG_PATH.read_text())["tpu"]["batch_buckets"]
    profiles = yaml.safe_load(DEFAULT_MODEL_CONFIG_PATH.read_text())["model"]["decode_profiles"]
    beams = sorted({int(p.get("beam_size", 1)) for p in profiles.values()})
    return sorted({rows * beam for beam in beams for rows in buckets})


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
    # every served shape over the 30 s bucket's keys (the beam path's among
    # them: rows x beam) in the two narrow storages the policies select
    cases += [(st, b, 1500, 12) for b in served_decode_rows() if b not in (4, 16)
              for st in ("fp8", "int8")]
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


def cross_mm_phase(torch, W, dev) -> dict:
    """Phase 2 for the int8-code cross-attention products, which the
    default path's decode step launches once each a decoder layer: both
    launches against their plain versions on the same card inputs at the
    served rungs (1/4/16/64 rows x the 5 s and 30 s buckets' 250 and 1500
    keys x whisper-small's 12 and large-v3-turbo's 20 heads, Dh 64), at
    CROSS_ATOL / CROSS_RTOL; times (cold) each launch, its plain version
    and the widening route it replaces (the codes widened to a bf16 copy,
    then ``_attn_cached``'s product), beside its bound. Returns, for
    ``cross_logits`` and ``cross_mix``, the largest error and the numbers
    at 64 rows x 12 heads x 1500 keys."""
    from stt_tpu_torch.ops.kernels.cross_mm import (
        cross_logits, cross_logits_plain, cross_mix, cross_mix_plain, plan_logits, plan_mix,
    )

    dh = 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"cross_logits": {"max_abs_err": 0.0}, "cross_mix": {"max_abs_err": 0.0}}
    for h in (12, 20):
        for b in (1, 4, 16, 64):
            for ta in (250, 1500):
                gen = torch.Generator(device=dev).manual_seed(b * 10000 + h * 100 + ta)
                scale = dh ** -0.25
                k, ks = W._q8(torch.randn((b, h, ta, dh), generator=gen, device=dev) * scale)
                v, _ = W._q8(torch.randn((b, h, ta, dh), generator=gen, device=dev))
                q = ((torch.randn((b, h, dh), generator=gen, device=dev) * scale * ks[..., 0])
                     .to(torch.bfloat16).contiguous())
                q4 = q[:, :, None, :]
                w = torch.softmax(cross_logits_plain(q, k), dim=-1)
                bh, n = b * h, b * h * ta * dh
                launches = {
                    "cross_logits": dict(
                        fn=cross_logits, kernel=lambda: cross_logits(q, k),
                        plain=lambda: cross_logits_plain(q, k),
                        library=lambda: W._bmm_f32(
                            q4, k.to(torch.bfloat16).transpose(-1, -2))[:, :, 0, :],
                        nbytes=q.numel() * 2 + n + bh * ta * 4,
                        plan=f"{plan_logits(bh, ta, dh, sms)} keys a block"),
                    "cross_mix": dict(
                        fn=cross_mix, kernel=lambda: cross_mix(w, v),
                        plain=lambda: cross_mix_plain(w, v),
                        library=lambda: W._bmm_f32(
                            w.to(torch.bfloat16)[:, :, None, :],
                            v.to(torch.bfloat16))[:, :, 0, :],
                        nbytes=bh * ta * 4 + n + bh * dh * 4,
                        plan="cluster {} x {} keys".format(*plan_mix(bh, ta, dh, sms))),
                }
                for name, run in launches.items():
                    before = run["fn"].launches
                    got, ref, lib = run["kernel"](), run["plain"](), run["library"]()
                    torch.cuda.synchronize()
                    after = run["fn"].launches
                    tag = f"{name} B{b} H{h} Ta{ta} int8 ({run['plan']})"
                    if got.shape != ref.shape or got.dtype != torch.float32 \
                            or not torch.isfinite(got).all() or after != before + 1:
                        fail(f"{tag}: {got.dtype} {tuple(got.shape)}, non-finite values or "
                             f"{after - before} launches")
                    err = (got - ref).abs().max().item()
                    result[name]["max_abs_err"] = max(result[name]["max_abs_err"], err)
                    used = limit_used(got, ref, CROSS_ATOL, CROSS_RTOL)
                    try:
                        torch.testing.assert_close(got, ref, atol=CROSS_ATOL, rtol=CROSS_RTOL)
                    except AssertionError as exc:
                        fail(f"{tag}: kernel disagrees with plain: {exc}")
                    k_ms = cuda_ms_cold(torch, run["kernel"])
                    p_ms = cuda_ms_cold(torch, run["plain"])
                    l_ms = cuda_ms_cold(torch, run["library"])
                    b_ms, b_by = bound(run["nbytes"], 2.0 * n, H100_F32_FLOPS)
                    lib_err = (lib - ref).abs().max().item()
                    log(f"{tag}: max_abs_err {err:.3g} (widening route {lib_err:.3g}), "
                        f"{used:.3g} of the limit, max |ref| {ref.abs().max().item():.3g}; "
                        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, widening route "
                        f"{l_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}), {b_ms / k_ms:.1%} of "
                        f"the bound, {run['nbytes'] / 1e6:.2f} MB")
                    if (b, h, ta) == (64, 12, 1500):
                        result[name].update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                            bound_ms=b_ms, bound_by=b_by)
    return result


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
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b * h, t, dh,
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


def narrow_phase(torch, W, dev) -> None:
    """Phase 2b: the model's products with narrow operands and float32
    accumulation (``bmm``/``mm`` with ``out_dtype=float32``, the route the
    card takes) against the float32 route (operands upcast, then multiplied
    in float32: the CPU's route), on the same inputs at the shapes of the
    served decode (4 and 64 rows x 10 s: self-attention over all 84 cache
    slots under the mask, cross attention over 500 int8 positions with their
    scales, the logits against the 51865 x 768 table) and of the 10 s
    encode (500 x 500 self-attention). The cross attention over int8 takes
    the int8-code products on the card (``cross_mm_phase`` holds them at
    every served rung), not the ``out_dtype`` overloads; each line names the
    route. Times both routes (cold)."""
    import types

    import torch.nn.functional as F

    def upcast_attn(q, k, v, mask=None):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(weights.float(), v.to(q.dtype).float())

    h, dh, d, vocab, t_max, ta = 12, 64, 768, 51865, 84, 500
    scale = dh ** -0.25
    for rows in (4, 64):
        gen = torch.Generator(device=dev).manual_seed(rows)

        def randn(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * sc).to(torch.bfloat16)

        def randq(*shape):
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)

        q = randn(rows, h, 1, dh, sc=scale)
        k, v = randn(rows, h, t_max, dh, sc=scale), randn(rows, h, t_max, dh)
        mask = torch.where(torch.arange(t_max, device=dev) <= 40, 0.0, -torch.inf)
        ks = torch.rand((1, rows, h, 1, 1), generator=gen, device=dev) * 0.01 + 0.005
        vs = torch.rand((1, rows, h, 1, 1), generator=gen, device=dev) * 0.01 + 0.005
        ckv = W.CrossKV(randq(1, rows, h, ta, dh), randq(1, rows, h, ta, dh), ks, vs)
        dec = types.SimpleNamespace(tok=randn(vocab, d, sc=0.02), tok_q=None)
        x = randn(rows, d)
        eq, ek, ev = (randn(rows, h, ta, dh, sc=sc) for sc in (scale, scale, 1.0))
        cases = {
            "self-attention, 84 slots": (
                lambda: W._attn_cached(q, k, v, mask), lambda: upcast_attn(q, k, v, mask),
                (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4, NARROW_ATTN_TOL,
                "out_dtype route"),
            "cross attention, 500 int8": (
                lambda: W._cross_layer_attn(q, ckv, 0),
                lambda: upcast_attn(q * ks[0].to(q.dtype), ckv.k[0], ckv.v[0]) * vs[0],
                q.numel() * 2 + ckv.k.numel() * 2 + q.numel() * 4, NARROW_ATTN_TOL,
                "int8-code products"),
            "logits, 51865 x 768": (
                lambda: W._tok_logits(dec, x), lambda: F.linear(x.float(), dec.tok.float()),
                (x.numel() + dec.tok.numel()) * 2 + rows * vocab * 4, NARROW_LOGITS_TOL,
                "out_dtype route"),
            "encoder self-attention, 500 x 500": (
                lambda: W._attn_cached(eq, ek, ev), lambda: upcast_attn(eq, ek, ev),
                eq.numel() * 2 * 3 + eq.numel() * 4, NARROW_ATTN_TOL, "out_dtype route"),
        }
        for name, (narrow, upcast, nbytes, (atol, rtol), route) in cases.items():
            tag = f"narrow operands {rows} rows, {name}"
            got, ref = narrow(), upcast()
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or got.shape != ref.shape \
                    or not torch.isfinite(got).all():
                fail(f"{tag}: {got.dtype} {tuple(got.shape)} or non-finite values")
            err = (got - ref).abs().max().item()
            used = limit_used(got, ref, atol, rtol)
            try:
                torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
            except AssertionError as exc:
                fail(f"{tag}: {route} disagrees with the float32 route: {exc}")
            n_ms, u_ms = cuda_ms_cold(torch, narrow), cuda_ms_cold(torch, upcast)
            log(f"{tag}: max_abs_err {err:.3g}, {used:.3g} of the limit (atol {atol:g}, "
                f"rtol {rtol:g}), max |ref| {ref.abs().max().item():.3g}; {route} "
                f"{n_ms:.4f} ms, float32 route {u_ms:.4f} ms, bound {nbytes / H100_HBM_BYTES * 1e3:.4f}"
                f" ms (bytes, narrow operands)")


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


def prewarm(engine, buckets, drafted: bool = False) -> int:
    """Prewarms ``buckets`` at 1 and 4 rows (the batch buckets a served
    phase's groups reach), with their drafted entries if ``drafted``;
    returns the graphs captured so far."""
    import torch

    sec = engine.prewarm(buckets, [1, 4], include_drafted=drafted)
    log(f"prewarm {'/'.join(f'{b:g}' for b in buckets)} s x 1/4 rows"
        f"{' with drafted entries' if drafted else ''}: {sec:.2f} s, "
        f"{engine.graph_captures} decode graphs captured, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    return engine.graph_captures


def counted_run(W, engine, run):
    """Runs ``run()`` with every kernel's launch count set to 0 just before
    and read just after; returns (its result, the counts). A kernel
    launched inside a captured decode chunk counts the launches the capture
    recorded times the chunk's replays, and the decoder steps are the
    uncaptured ones plus ``FINISH_CHECK_EVERY`` a replay."""
    from stt_tpu_torch.ops.kernels.cross_mm import cross_logits, cross_mix
    from stt_tpu_torch.ops.kernels.flash_attention import flash_attention
    from stt_tpu_torch.ops.kernels.mel import mel_logspec
    from stt_tpu_torch.ops.kernels.xattn_decode import xattn_decode

    step = W._decoder_step
    steps = [0]

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    replayed = engine.graphs.replayed_launches()
    replays = engine.graph_replays
    mel_logspec.launches = xattn_decode.launches = flash_attention.launches = 0
    cross_logits.launches = cross_mix.launches = 0
    W._decoder_step = counted_step
    try:
        result = run()
    finally:
        W._decoder_step = step
    in_graphs = {k: v - replayed[k] for k, v in engine.graphs.replayed_launches().items()}
    counts = {"mel_logspec": mel_logspec.launches + in_graphs["mel_logspec"],
              "xattn_decode": xattn_decode.launches + in_graphs["xattn_decode"],
              "flash_attention": flash_attention.launches + in_graphs["flash_attention"],
              "xattn_decode_in_graphs": in_graphs["xattn_decode"],
              "cross_logits": cross_logits.launches + in_graphs["cross_logits"],
              "cross_mix": cross_mix.launches + in_graphs["cross_mix"],
              "cross_logits_in_graphs": in_graphs["cross_logits"],
              "graph_replays": engine.graph_replays - replays,
              "decoder_steps": steps[0] + W.FINISH_CHECK_EVERY * (
                  engine.graph_replays - replays)}
    return result, counts


def graphs_phase(torch, E, W, engine, seconds: float, rows: int, tag: str) -> dict:
    """Phase 3c on one prewarmed engine: a group of ``rows`` requests of
    ``seconds`` (alternately a fixed and a detected language) decoded on
    its entry by replaying the captured chunk (and tail) and by the same
    steps uncaptured; tokens, lengths and logprob sums must be bitwise
    identical. Prints and returns both ms per decode step (CUDA events),
    keyed captured True / False."""
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
    return ms


def serve_default_phase(torch, E, W, audio_wire: str) -> int:
    """Phase 3a: whisper-small bf16 on the default attention path (int8
    cross K/V, einsum attention), 8 concurrent requests of 1-10 s on the
    given audio wire, after a prewarm of their shapes. Checks that every
    log-mel launch of the run received rows of the wire's type, that each
    int8-code cross-attention product launched once per decoder layer per
    decoder step, inside the replayed graphs too (:func:`counted_run`), and
    that no decode graph was captured while serving; on the mu-law wire it
    then holds the captured decode against the uncaptured one (phase 3c).
    Returns the run's launch counts."""
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
        (results, wall), counts = counted_run(
            W, engine, lambda: serve_concurrently(engine, requests))
        launches = counts["mel_logspec"]
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
    per_step = cfg.n_text_layer * counts["decoder_steps"]
    if (counts["decoder_steps"] <= 0 or counts["cross_logits_in_graphs"] <= 0
            or counts["cross_logits"] != per_step or counts["cross_mix"] != per_step):
        fail(f"{audio_wire} wire: the int8-code products launched {counts['cross_logits']} "
             f"and {counts['cross_mix']} times ({counts['cross_logits_in_graphs']} in "
             f"replayed graphs) for {counts['decoder_steps']} decoder steps, not "
             f"{cfg.n_text_layer} per step")
    log(f"served {len(requests)} requests on the {audio_wire} wire in {wall:.3f} s; "
        f"mel_logspec launches {launches}, each on {wire_dtype} rows; launches {counts}; "
        f"no decode graph captured while serving ({engine.graph_replays} replays so far)")
    front_end_share(torch, E, engine, (1.0, 2.0, 5.0, 10.0), audio_wire)
    if audio_wire == "mulaw":
        graphs_phase(torch, E, W, engine, 10.0, 4, "whisper-small bf16, int8 cross K/V, einsum")
    return counts


def serve_30s_phase(torch, E, W):
    """Phase 3b: whisper-small bf16 with fp8 cross K/V and both attention
    kernels on, 4 concurrent requests in the 30 s bucket, after a prewarm
    of their shapes (with their drafted entries), then the same audio as
    two ticks of drafted partials (``draft_mode="on"``: the first tick's
    drafts are empty, the second's are the first's tokens), whose resume
    steps run ``xattn_decode``. Returns the launch counts of both runs
    (:func:`counted_run`). Then holds the captured decode against the
    uncaptured one (phase 3c)."""
    t0 = time.monotonic()
    engine = E.WhisperEngine(
        "small", device="cuda", compute_type="bfloat16",
        batch_buckets=(1, 4, 16, 64), batch_window_ms=50.0, max_decode_tokens=224,
        cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto", draft_mode="on",
    )
    cfg = engine.config
    log(f"engine (30 s path): whisper-{cfg.name} bf16, policy {engine.policy}; built in "
        f"{time.monotonic() - t0:.1f} s")
    durations = [12.0, 20.0, 25.0, 30.0]

    def requests(final: bool, tag: str):
        return [E.DecodeRequest(synth_audio(d, seed=20 + i),
                                language=None if i % 2 else "en",
                                session_id=f"smoke30-{tag}-{i}", is_final=final)
                for i, d in enumerate(durations)]

    def drafted_ticks():
        ticks = [serve_concurrently(engine, requests(False, "draft")) for _ in range(2)]
        return ticks, dict(engine.draft_stats)

    try:
        t0 = time.monotonic()
        engine.transcribe_sync(E.DecodeRequest(synth_audio(30.0, 8), language="en"))
        log(f"warm-up request (30 s): {time.monotonic() - t0:.2f} s")
        captures = prewarm(engine, [30.0], drafted=True)
        finals = requests(True, "final")
        (results, wall), counts = counted_run(
            W, engine, lambda: serve_concurrently(engine, finals))
        check_served(E, W, engine, finals, results)
        (ticks, stats), drafted = counted_run(W, engine, drafted_ticks)
        for tick_results, _ in ticks:
            check_served(E, W, engine, requests(False, "draft"), tick_results)
        served_captures = engine.graph_captures - captures
    finally:
        engine.close()
    if served_captures:
        fail(f"30 s path: {served_captures} decode graphs captured while serving prewarmed "
             f"shapes")
    if engine._thread is not None or engine._harvest_thread is not None:
        fail("engine threads still running after close()")
    if stats["rows"] <= 0 or stats["offered"] <= 0:
        fail(f"30 s path: the second tick carried no drafts: {stats}")
    for tag, c in (("finals", counts), ("drafted partials", drafted)):
        if c["xattn_decode_in_graphs"] <= 0:
            fail(f"30 s path, {tag}: no xattn_decode launch inside a replayed decode graph")
        encodes = c["mel_logspec"]
        if encodes <= 0 or c["flash_attention"] != cfg.n_audio_layer * encodes:
            fail(f"30 s path, {tag}: flash_attention launched {c['flash_attention']} times "
                 f"for {encodes} encodes, not {cfg.n_audio_layer} per encode")
        if c["decoder_steps"] <= 0 or (
                c["xattn_decode"] != cfg.n_text_layer * c["decoder_steps"]):
            fail(f"30 s path, {tag}: xattn_decode launched {c['xattn_decode']} times for "
                 f"{c['decoder_steps']} decoder steps, not {cfg.n_text_layer} per step")
    log(f"served {len(finals)} requests (30 s bucket) in {wall:.3f} s; launches {counts}; "
        f"then 2 ticks of {len(durations)} drafted partials in "
        f"{sum(w for _, w in ticks):.3f} s, draft stats {stats}; launches {drafted}; "
        f"no decode graph captured while serving")
    front_end_share(torch, E, engine, (30.0,), "mulaw")
    graphs_phase(torch, E, W, engine, 30.0, 4, "whisper-small bf16, fp8 cross K/V, both kernels")
    return {k: v + drafted[k] for k, v in counts.items()}


def beam_graphs_check(torch, E, W, engine, seconds: float, rows: int, tag: str) -> None:
    """Phase 3e on one prewarmed beam entry: a group of ``rows`` requests
    of ``seconds`` (alternately a fixed and a detected language, detected on
    the rows before the beams replicate them) decoded at beam 5 by replaying
    the captured chunk, by the same chunk uncaptured and by the uncaptured
    ``beam_decode``; the first two must agree bit for bit, the third in
    tokens and lengths."""
    bucket = engine._bucket_for(int(seconds * 16000))
    pcm = np.zeros((rows, int(bucket * 16000)), np.int16)
    for i in range(rows):
        audio = synth_audio(seconds * (0.6 + 0.4 * i / max(1, rows - 1)), seed=70 + i)
        pcm[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    prompt = np.array([W.build_prompt(engine.config, "en")] * rows, np.int64)
    auto = np.arange(rows) % 2 == 1
    max_new = engine._max_new_for(bucket)
    dev = engine.device
    with engine._device_lock, torch.inference_mode():
        rows_dev = torch.from_numpy(E._encode_wire_rows(pcm, engine.audio_wire)).to(dev)
        enc = E._mel_encode(engine.model, rows_dev, engine._dtype)
        entry = engine.graphs.lookup(bucket, rows, prompt.shape[1], max_new, BEAM)
        ckv = W.precompute_cross_kv(engine.model.decoder, enc)
        prompt_dev, _, _ = E._detect_and_patch_lang(
            engine.model, enc, torch.from_numpy(prompt).to(dev), torch.from_numpy(auto).to(dev),
            ckv, 1)
        W.repeat_cross_kv(ckv, BEAM, out=entry.cross_kv)
        plen = torch.full((rows,), prompt.shape[1], dtype=torch.long, device=dev)
        got = {captured: engine.graphs.decode(entry, prompt_dev, plen, captured=captured)
               for captured in (True, False)}
        plain = W.beam_decode(engine.model, enc, prompt_dev, plen, max_new, beam_size=BEAM)
        torch.cuda.synchronize()
    a, b = got[True], got[False]
    for name in ("tokens", "lengths", "sum_logprob"):
        x, y = getattr(a, name), getattr(b, name)
        if not torch.equal(x, y):
            fail(f"beam graphs ({tag}): captured and uncaptured {name} differ: "
                 f"{x.tolist()} vs {y.tolist()}")
    for name in ("tokens", "lengths"):
        if not torch.equal(getattr(a, name), getattr(plain, name)):
            fail(f"beam graphs ({tag}): captured and beam_decode {name} differ: "
                 f"{getattr(a, name).tolist()} vs {getattr(plain, name).tolist()}")
    if not torch.isfinite(a.sum_logprob).all():
        fail(f"beam graphs ({tag}): non-finite logprob sums {a.sum_logprob.tolist()}")
    log(f"beam graphs ({tag}, {rows} x {bucket:g} s, beam {BEAM}, max_new {max_new}, "
        f"{entry.launches.get('xattn_decode', 0)} xattn_decode launches a chunk): captured and "
        f"uncaptured tokens, lengths and logprob sums bitwise identical, beam_decode's tokens "
        f"and lengths identical (lengths {a.lengths.tolist()}, logprob sums "
        f"{[round(x, 4) for x in a.sum_logprob.tolist()]}; beam_decode's differ by at most "
        f"{(a.sum_logprob - plain.sum_logprob).abs().max().item():.3g})")


def beam_step_times(torch, engine, bucket: float, rows: int, tag: str) -> dict:
    """ms per beam-5 step, captured and eager (CUDA events), beside the
    step's bound (the bytes it needs over the card's memory rate: the cross
    K/V once a row, the self cache once) and beside the bytes this design
    moves (the cross K/V once a beam, the self cache once more for the
    reorder by parent beam)."""
    from stt_tpu_torch import bench as B

    ms = {c: B.decode_step_ms(engine, bucket, rows, captured=c, beam=BEAM) for c in (True, False)}
    nbytes = B.decode_step_bytes(engine, bucket, rows, beam=BEAM)
    entry = engine.graphs.lookup(bucket, rows, B.PROMPT_LEN, engine._max_new_for(bucket), BEAM)
    cache = sum(t.numel() * t.element_size() for t in entry.state.cache)
    cross = sum(t.numel() * t.element_size() for t in entry.cross_kv if t is not None)
    design = nbytes + cross - cross // BEAM + cache
    bound_ms = nbytes / H100_HBM_BYTES * 1e3
    design_ms = design / H100_HBM_BYTES * 1e3
    log(f"beam step ({tag}, {rows} x {bucket:g} s x beam {BEAM}): captured {ms[True]:.4f} ms, "
        f"eager {ms[False]:.4f} ms; {nbytes / 1e6:.1f} MB a step needs (cross K/V once a row, "
        f"self cache {cache / 1e6:.1f} MB once), bound {bound_ms:.4f} ms (bytes), captured at "
        f"{bound_ms / ms[True]:.1%} of it; bytes of the repeated-cross, reorder design "
        f"{design / 1e6:.1f} MB, {design_ms:.4f} ms")
    return {"rows": rows, "captured_ms": ms[True], "eager_ms": ms[False],
            "bytes": nbytes, "bound_ms": bound_ms, "design_bytes": design,
            "design_ms": design_ms}


def serve_beam_phase(torch, E, W, tag: str, policy: dict, durations, timing_rows):
    """Phase 3e on one attention path: whisper-small bf16 at beam 5 (the
    ``accurate`` profile), 4 concurrent requests of ``durations`` in one
    bucket after a prewarm of that bucket at beam 5; returns the launch
    counts of the run (counted as phase 3b counts them) and the step times
    at ``timing_rows``."""
    engine = E.WhisperEngine(
        "small", device="cuda", compute_type="bfloat16",
        batch_buckets=(1, 4, 16, 64), batch_window_ms=50.0, max_decode_tokens=224, **policy,
    )
    cfg = engine.config
    bucket = engine._bucket_for(int(max(durations) * 16000))
    try:
        sizes = sorted({1, 4, *timing_rows})
        sec = engine.prewarm([bucket], sizes, beam_sizes=[BEAM])
        captures = engine.graph_captures
        log(f"beam prewarm ({tag}, policy {engine.policy}): {bucket:g} s x "
            f"{'/'.join(map(str, sizes))} rows at beam {BEAM} in {sec:.2f} s, {captures} beam "
            f"graphs captured, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
        requests = [
            E.DecodeRequest(synth_audio(d, seed=60 + i), language=None if i % 2 else "en",
                            options=dict(ACCURATE), session_id=f"smoke-beam-{i}",
                            is_final=True)
            for i, d in enumerate(durations)
        ]
        (results, wall), counts = counted_run(
            W, engine, lambda: serve_concurrently(engine, requests))
        served_captures = engine.graph_captures - captures
        check_served(E, W, engine, requests, results)
        if served_captures:
            fail(f"beam ({tag}): {served_captures} decode graphs captured while serving "
                 f"prewarmed shapes")
        encodes = counts["mel_logspec"]
        flash_on = engine.policy.flash_on(1500) and bucket == 30.0
        if encodes <= 0 or counts["graph_replays"] <= 0:
            fail(f"beam ({tag}): launches {counts}")
        if counts["flash_attention"] != (cfg.n_audio_layer * encodes if flash_on else 0):
            fail(f"beam ({tag}): flash_attention launched {counts['flash_attention']} times "
                 f"for {encodes} encodes")
        if counts["xattn_decode"] != (cfg.n_text_layer * counts["decoder_steps"]
                                      if engine.policy.xattn_on else 0):
            fail(f"beam ({tag}): xattn_decode launched {counts['xattn_decode']} times for "
                 f"{counts['decoder_steps']} decoder steps")
        codes = "cross_mm" in W.decode_sources(engine.policy, engine._dtype)
        if not (counts["cross_logits"] == counts["cross_mix"]
                == (cfg.n_text_layer * counts["decoder_steps"] if codes else 0)):
            fail(f"beam ({tag}): the int8-code products launched {counts['cross_logits']} and "
                 f"{counts['cross_mix']} times for {counts['decoder_steps']} decoder steps")
        log(f"beam ({tag}): served {len(requests)} accurate requests ({bucket:g} s bucket) in "
            f"{wall:.3f} s; launches {counts}; no decode graph captured while serving")
        beam_graphs_check(torch, E, W, engine, max(durations), 4, tag)
        times = [beam_step_times(torch, engine, bucket, rows, tag) for rows in timing_rows]
    finally:
        engine.close()
    return counts, times


def graphs_f32_phase(torch, E, W) -> None:
    """Phase 3c for the ``test`` model in float32 on the card."""
    engine = E.WhisperEngine("test", device="cuda", compute_type="float32",
                             batch_buckets=(1, 4, 16, 64))
    prewarm(engine, [10.0])
    graphs_phase(torch, E, W, engine, 10.0, 4, "test model, float32")
    engine.close()


def drafted_group(torch, E, W, engine, rows: int, seed: int, bucket: float = 5.0):
    """A group of ``rows`` requests of 60-100% of ``bucket`` (by default
    5 s, the partial window) in language en, encoded into the cross K/V
    that the shape's greedy and drafted entries share; returns (plain
    entry, drafted entry, prompt, prompt lengths)."""
    pcm = np.zeros((rows, int(bucket * 16000)), np.int16)
    for i in range(rows):
        audio = synth_audio(bucket * (0.6 + 0.4 * i / max(1, rows - 1)), seed=seed + i % 8)
        pcm[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    prompt = np.array([W.build_prompt(engine.config, "en")] * rows, np.int64)
    max_new = engine._max_new_for(bucket)
    dev = engine.device
    with engine._device_lock, torch.inference_mode():
        rows_dev = torch.from_numpy(E._encode_wire_rows(pcm, engine.audio_wire)).to(dev)
        enc = E._mel_encode(engine.model, rows_dev, engine._dtype)
        plain = engine.graphs.lookup(bucket, rows, prompt.shape[1], max_new)
        drafted = engine.graphs.lookup(bucket, rows, prompt.shape[1], max_new, drafted=True)
        W.precompute_cross_kv(engine.model.decoder, enc, out=plain.cross_kv)
        plen = torch.full((rows,), prompt.shape[1], dtype=torch.long, device=dev)
        torch.cuda.synchronize()
    return plain, drafted, torch.from_numpy(prompt).to(dev), plen


def lcp(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def plain_top2_gaps(torch, W, engine, plain, prompt, plen, tokens, first_diff: dict) -> dict:
    """The plain decode's top-2 gap of its masked logits at each row's
    first differing position (row -> position): its scalar steps rerun
    uncaptured (bitwise the captured chunk), teacher-forced on its own
    tokens, on a state of their own and the shape's cross K/V."""
    dec = engine.model.decoder
    key = plain.key
    st = W.init_decode_state(engine.config, key.rows, key.p_len, key.max_new, engine._dtype,
                             engine.device)
    gaps = {}
    with engine._device_lock, torch.inference_mode():
        W.start_decode(dec, st, prompt, plen, plain.cross_kv)
        for t in range(key.p_len, max(first_diff.values()) + 1):
            logits = W._decoder_step(dec, tokens[:, t - 1], t - 1, st.cache, plain.cross_kv)
            logits = logits + st.suppress + torch.where((st.prompt_len == t)[:, None],
                                                        st.begin, 0.0)
            for row, pos in first_diff.items():
                if pos == t:
                    top = torch.topk(logits[row], 2).values
                    gaps[row] = float(top[0] - top[1])
    return gaps


def drafted_decodes(torch, engine, plain, drafted, prompt, plen, draft, dlen,
                    captured: bool = True):
    """(plain result, drafted result) of one group on its two entries."""
    with engine._device_lock, torch.inference_mode():
        base = engine.graphs.decode(plain, prompt, plen, captured=captured)
        got = engine.graphs.decode(drafted, prompt, plen, draft=draft, draft_len=dlen,
                                   captured=captured)
        torch.cuda.synchronize()
    return base, got


def accepted_draft(torch, engine, drafted, prompt, plen, draft, dlen, limit: int = 48):
    """A draft that every row's verify pass accepts whole: drafted decodes
    fed their own output until each row accepts all of its draft. The
    verify pass is causal, so each pass accepts at least one token more
    than the one before (the corrected token at the first mismatch is its
    own choice). Returns (draft, lengths, passes)."""
    p_len = drafted.key.p_len
    for n in range(1, limit + 1):
        with engine._device_lock, torch.inference_mode():
            got = engine.graphs.decode(drafted, prompt, plen, draft=draft, draft_len=dlen)
        if torch.equal(got.n_accepted, dlen):
            return draft, dlen, n
        draft, dlen = got.tokens[:, p_len:].clone(), got.lengths - p_len
    fail(f"drafted: no fully accepted draft after {limit} passes")


def group_ms(torch, engine, fn, reps: int = 5) -> float:
    """Median device-clock ms of ``fn`` (CUDA events around it, host reads
    inside included), after one warm-up call."""
    times = []
    with engine._device_lock, torch.inference_mode():
        for i in range(reps + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    return float(np.median(times))


def drafted_gate_f32(torch, E, W) -> None:
    """Phase 3f's float32 gate: the ``test`` model on the card, 4 rows of
    5 s with an empty, a perfect, an adversarial and a mid-mutation draft:
    drafted tokens and lengths equal the plain decode's, each row's
    accepted count is the longest common prefix of its draft and the plain
    tokens, and the captured resume replays give the uncaptured chunk's
    tokens, lengths, logprob sums and accepted counts bit for bit."""
    engine = E.WhisperEngine("test", device="cuda", compute_type="float32",
                             batch_buckets=(1, 4, 16, 64), draft_mode="on")
    try:
        engine.prewarm([5.0], [4], include_drafted=True)
        plain, drafted, prompt, plen = drafted_group(torch, E, W, engine, 4, seed=80)
        with engine._device_lock, torch.inference_mode():
            base = engine.graphs.decode(plain, prompt, plen)
        p_len, max_new = plain.key.p_len, plain.key.max_new
        eot = engine.layout.eot
        gens = [base.tokens[i, p_len:int(base.lengths[i])].tolist() for i in range(4)]
        rng = np.random.default_rng(3)
        cut = len(gens[3]) // 2
        rows = [[], gens[1], rng.integers(10, 400, size=max_new).tolist(),
                gens[3][:cut] + [(gens[3][cut] + 1) % 400 + 10] + gens[3][cut + 1:]]
        draft = torch.full((4, max_new), eot, dtype=torch.long, device=engine.device)
        for i, r in enumerate(rows):
            draft[i, :len(r)] = torch.tensor(r, dtype=torch.long)
        dlen = torch.tensor([len(r) for r in rows], device=engine.device)
        got = {c: drafted_decodes(torch, engine, plain, drafted, prompt, plen, draft, dlen, c)[1]
               for c in (True, False)}
    finally:
        engine.close()
    a, b = got[True], got[False]
    for name in ("tokens", "lengths", "sum_logprob", "n_accepted"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            fail(f"drafted f32: captured and uncaptured {name} differ")
    if not (torch.equal(a.tokens, base.tokens) and torch.equal(a.lengths, base.lengths)):
        fail(f"drafted f32: tokens or lengths differ from the plain decode's: lengths "
             f"{a.lengths.tolist()} vs {base.lengths.tolist()}")
    want = [lcp(r, g) for r, g in zip(rows, gens)]
    if a.n_accepted.tolist() != want:
        fail(f"drafted f32: accepted {a.n_accepted.tolist()}, the drafts' common prefixes "
             f"with the plain tokens are {want}")
    log(f"drafted f32 (test model, 4 x 5 s; empty, perfect, adversarial, mid-mutation "
        f"drafts): tokens and lengths equal the plain decode's (lengths "
        f"{base.lengths.tolist()}), accepted {a.n_accepted.tolist()} = the common prefixes; "
        f"captured resume bitwise the uncaptured chunk")


def drafted_phase(torch, E, W) -> int:
    """Phase 3f: drafted partials on whisper-small bf16, default path (int8
    cross K/V, einsum), 5 s bucket: the float32 gate
    (:func:`drafted_gate_f32`); at 4 and 64 rows, plain and drafted decodes
    at acceptance 1 (the draft is the plain decode's own tokens) and 0 (a
    draft of ``sot``, which greedy never writes), every row where a drafted
    and the plain tokens differ printed with the plain decode's top-2 logit
    gap at the first difference (a gap above ``BF16_TIE_GAP`` fails); the
    decode times (CUDA events) of the plain decode, of the drafted decode
    with the plain tokens as drafts (bf16 near-ties make the verify pass
    reject some of them), with drafts every row accepts whole
    (:func:`accepted_draft`) and at acceptance 0, and of the verify pass
    alone, with the break-even acceptance beside ``STT_DRAFT_ENGAGE``: a
    group resumes until its last row finishes, so its time follows the
    acceptance of its least-accepting row, interpolated here between the
    whole and the zero acceptance; then 3 ticks
    of 64 sessions under ``draft_mode="on"`` and under ``"adaptive"`` after
    a prewarm with drafted entries, failing if a graph is captured while
    serving. Returns the log-mel launches of the served ticks."""
    drafted_gate_f32(torch, E, W)
    from stt_tpu_torch.ops.kernels.mel import mel_logspec

    def build(mode: str):
        engine = E.WhisperEngine(
            "small", device="cuda", compute_type="bfloat16", batch_buckets=(1, 4, 16, 64),
            max_batch=64, batch_window_ms=50.0, max_decode_tokens=224,
            cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off", draft_mode=mode)
        sec = engine.prewarm([5.0], [1, 4, 16, 64], include_drafted=True)
        log(f"drafted ({mode}): prewarm 5 s x 1/4/16/64 rows with drafted entries in "
            f"{sec:.2f} s, {engine.graph_captures} graphs, "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
        return engine

    def serve_ticks(engine, mode: str) -> int:
        sessions = [synth_audio(7.0, seed=90 + i % 16) for i in range(64)]
        captures = engine.graph_captures
        mel_logspec.launches = 0
        for tick in range(3):
            end = int((5.0 + 0.5 * tick) * 16000)
            t0 = time.monotonic()
            futs = [engine.submit(E.DecodeRequest(a[end - 80000:end], language="en",
                                                  session_id=f"smoke-draft-{i}"))
                    for i, a in enumerate(sessions)]
            outs = [f.result(timeout=300) for f in futs]
            log(f"drafted ({mode}): tick {tick}, 64 partials in {time.monotonic() - t0:.3f} s, "
                f"groups of {sorted({o.batch_rows for o in outs})} rows, draft stats "
                f"{engine.draft_stats}")
        if engine.graph_captures != captures:
            fail(f"drafted ({mode}): {engine.graph_captures - captures} graphs captured while "
                 f"serving")
        if mode == "on" and engine.draft_stats["offered"] <= 0:
            fail(f"drafted (on): no draft offered in 3 ticks: {engine.draft_stats}")
        return mel_logspec.launches

    engine = build("on")
    try:
        for rows in (4, 64):
            plain, drafted, prompt, plen = drafted_group(torch, E, W, engine, rows, seed=100)
            p_len, max_new = plain.key.p_len, plain.key.max_new
            with engine._device_lock, torch.inference_mode():
                base = engine.graphs.decode(plain, prompt, plen)
            perfect = base.tokens[:, p_len:].clone()
            perfect_len = base.lengths - p_len
            never = torch.full_like(perfect, engine.layout.sot)
            full = torch.full_like(perfect_len, max_new)
            for acc, draft, dlen in (("the plain tokens as drafts", perfect, perfect_len),
                                     ("acceptance 0", never, full)):
                _, got = drafted_decodes(torch, engine, plain, drafted, prompt, plen, draft, dlen)
                diff = {}
                for r in range(rows):
                    a, b = got.tokens[r].tolist(), base.tokens[r].tolist()
                    if a != b or int(got.lengths[r]) != int(base.lengths[r]):
                        diff[r] = lcp(a, b)
                gaps = plain_top2_gaps(torch, W, engine, plain, prompt, plen, base.tokens,
                                       diff) if diff else {}
                accepted = got.n_accepted.tolist()
                log(f"drafted bf16 ({rows} x 5 s, {acc}): accepted "
                    f"{sum(accepted)} of {int(dlen.sum())} draft tokens; {len(diff)} of {rows} "
                    f"rows differ from the plain decode"
                    + "".join(f"; row {r} first at position {diff[r]}, plain top-2 gap "
                              f"{gaps[r]:.4f}" for r in sorted(diff)))
                bad = {r: g for r, g in gaps.items() if g > BF16_TIE_GAP}
                if bad:
                    fail(f"drafted bf16: rows {bad} differ where the plain decode's top-2 gap "
                         f"exceeds {BF16_TIE_GAP}: not a tie")
            whole, whole_len, passes = accepted_draft(torch, engine, drafted, prompt, plen,
                                                      perfect, perfect_len)
            with engine._device_lock, torch.inference_mode():
                own = engine.graphs.decode(drafted, prompt, plen, draft=perfect,
                                           draft_len=perfect_len)
            own_rate = own.n_accepted.float() / perfect_len.clamp_min(1).float()
            ms = {
                "plain": group_ms(torch, engine, lambda: engine.graphs.decode(
                    plain, prompt, plen)),
                "plain_tokens": group_ms(torch, engine, lambda: engine.graphs.decode(
                    drafted, prompt, plen, draft=perfect, draft_len=perfect_len)),
                "acc1": group_ms(torch, engine, lambda: engine.graphs.decode(
                    drafted, prompt, plen, draft=whole, draft_len=whole_len)),
                "acc0": group_ms(torch, engine, lambda: engine.graphs.decode(
                    drafted, prompt, plen, draft=never, draft_len=full)),
                "verify": group_ms(torch, engine, lambda: W.start_drafted(
                    engine.model.decoder, drafted.state, prompt, plen, never, full,
                    drafted.cross_kv)),
            }
            t1, t0, tp = ms["acc1"], ms["acc0"], ms["plain"]
            if t0 <= tp:
                even = "0 (drafted wins at any acceptance)"
            elif t1 >= tp:
                even = "none (drafted loses at any acceptance)"
            else:
                even = f"{(t0 - tp) / (t0 - t1):.3f}"
            log(f"drafted times ({rows} x 5 s, max_new {max_new}, decode of one group, CUDA "
                f"events, median of 5): plain {tp:.3f} ms; drafted with the plain tokens as "
                f"drafts {ms['plain_tokens']:.3f} ms (accepted {own_rate.mean().item():.3f} of "
                f"them on average, {own_rate.min().item():.3f} in the least-accepting row); "
                f"at acceptance 1 (drafts accepted whole, found in {passes} passes) {t1:.3f} "
                f"ms; at acceptance 0 {t0:.3f} ms (its verify pass {ms['verify']:.3f} ms, "
                f"the resume {t0 - ms['verify']:.3f} ms); break-even acceptance of the "
                f"least-accepting row {even} (linear between 0 and 1) beside "
                f"STT_DRAFT_ENGAGE={engine._draft_engage}")
        launches = serve_ticks(engine, "on")
    finally:
        engine.close()
    engine = build("adaptive")
    try:
        launches += serve_ticks(engine, "adaptive")
    finally:
        engine.close()
    if launches <= 0:
        fail("drafted: the served ticks never launched the log-mel kernel")
    return launches


# -- phase 3g: the decode routes -------------------------------------------------

LADDER = {"temperature": [0.0, 0.2, 0.4], "best_of": 5, "log_prob_threshold": 0.0}
PREFIX_TEXT = "hello world this is the forced prefix"


def route_options(engine) -> dict:
    """Phase 3g's routes: name -> request options. The conditioning prompt
    is the streaming one (``_cond_ctx``), whose tokens the engine cuts to
    the 32-token bucket; ``prompt-drafted`` serves it as two ticks of
    partials under ``draft_mode="on"`` (the second drafted)."""
    words = []
    while len(engine.tokenizer.encode(" " + " ".join(words))) < 32:
        words.append(f"word{len(words)}")
    cond = {"initial_prompt": " ".join(words), "_cond_ctx": True}
    return {
        "prompt": cond,
        "prompt-drafted": cond,
        "prefix": {"prefix": PREFIX_TEXT},
        "penalty": {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3},
        "penalty-beam5": {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3,
                          "beam_size": BEAM},
        "ladder": LADDER,
        "timestamps": {"without_timestamps": False},
        "timestamps-beam5": {"without_timestamps": False, "beam_size": BEAM},
        "clips": {"clip_timestamps": "0.5,4.0,6.0"},
    }


def route_name(key) -> str:
    r = key.route
    parts = [n for n, on in (("timestamps", r.timestamps), ("sampled", r.sampled),
                             ("penalised", r.penalised)) if on]
    parts += [f"ngram {r.ngram_n}"] if r.ngram_n else []
    parts += ["drafted"] if key.drafted else []
    parts += [f"beam {key.beam}"] if key.beam > 1 else []
    return ", ".join(parts) or "greedy"


class TwinDecodes:
    """Stands in for ``engine.graphs.decode``: while ``on``, the first
    decode of each route on a captured entry runs twice, replaying the
    graph and running the same chunk uncaptured, and the two results must
    be bitwise equal (tokens, lengths, logprob sums, accepted counts; the
    sampled route's draws come from its generator reseeded by each decode,
    so this holds the captured sampler to the eager one). Keeps each
    entry's last call made while on."""

    def __init__(self, torch, engine) -> None:
        self.torch = torch
        self.real = engine.graphs.decode
        self.on = False
        self.checked = {}
        self.calls = {}
        engine.graphs.decode = self

    def __call__(self, entry, *args, **kwargs):
        name = route_name(entry.key)
        if not self.on or entry.graph is None or "captured" in kwargs:
            return self.real(entry, *args, **kwargs)
        self.calls[entry.key] = (entry, args, kwargs)
        if self.checked.get(name):
            return self.real(entry, *args, **kwargs)
        a = self.real(entry, *args, captured=True, **kwargs)
        b = self.real(entry, *args, captured=False, **kwargs)
        for field in a._fields:
            if not self.torch.equal(getattr(a, field), getattr(b, field)):
                fail(f"routes ({route_name(entry.key)}, {entry.key.rows} rows): captured and "
                     f"uncaptured {field} differ")
        self.checked[name] = 1
        return a


def check_timestamp_grammar(W, engine, name: str, out, duration: float) -> None:
    """openai-whisper's timestamp grammar on one output's generated tokens
    (``tests/test_whisper_model.py:248-335``): the first token a timestamp
    within the initial cap, then text, timestamps never decreasing, never
    three in a row; every segment within the audio."""
    ts_begin = engine.layout.timestamp_begin
    gen = [int(t) for t in out._tokens[out._p_len: out._p_len + out._n_gen]]
    if not gen:
        return
    stamps = [t for t in gen if t >= ts_begin]
    runs, run = [], 0
    for t in gen:
        run = run + 1 if t >= ts_begin else 0
        runs.append(run)
    if (not ts_begin <= gen[0] <= ts_begin + W.MAX_INITIAL_TIMESTAMP
            or (len(gen) > 1 and gen[1] >= ts_begin) or stamps != sorted(stamps)
            or max(runs) > 2):
        fail(f"routes ({name}): tokens break the timestamp grammar: {gen[:24]}")
    for seg in out.segments:
        if not 0.0 <= seg.start <= seg.end <= duration + 1e-6:
            fail(f"routes ({name}): segment {seg} outside {duration:g} s")


def route_group(E, W, engine, name: str, opts: dict, seconds: float, rows: int, tick: int):
    """One group of ``rows`` requests of the route (0.6-1 times
    ``seconds``, alternately en and detected) through the engine's device
    phase and harvest; partials with session ids on ``prompt-drafted``,
    else finals of fresh sessions (so nothing drafts them). Returns the
    tasks and (outputs, launch counts)."""
    partial = name == "prompt-drafted"
    tasks = []
    for i in range(rows):
        audio = synth_audio(seconds * (0.6 + 0.4 * i / max(1, rows - 1)), seed=90 + i % 8)
        task = E._Task(E.DecodeRequest(audio, language=None if i % 2 else "en",
                                       options=dict(opts), session_id=f"route-{name}-{rows}-{i}",
                                       is_final=not partial), None)
        engine._attach_draft(task)
        tasks.append(task)
    return tasks, counted_run(W, engine, lambda: engine._harvest(engine._device_phase(tasks)))


def check_route(W, engine, name: str, opts: dict, tasks, outs) -> None:
    """What each route promises of its outputs."""
    for task, out in zip(tasks, outs):
        duration = len(task.request.audio) / 16000
        if not (np.isfinite(out.avg_logprob) and out.info.language in W.WHISPER_LANG_CODES):
            fail(f"routes ({name}): bad output {out.avg_logprob} {out.info}")
        if "without_timestamps" in opts:
            check_timestamp_grammar(W, engine, name, out, duration)
        text = " ".join(s.text for s in out.segments).strip()
        if "prefix" in opts and out.segments and not text.startswith(PREFIX_TEXT):
            fail(f"routes ({name}): the transcript does not lead with the prefix: {text[:60]!r}")
        if opts is LADDER and out.temperature_used not in LADDER["temperature"][1:]:
            fail(f"routes (ladder): a row kept temperature {out.temperature_used} though "
                 f"log_prob_threshold 0 fails every random-weight decode")
        if "_cond_ctx" in opts and out._p_len != 1 + 32 + 4:
            fail(f"routes ({name}): prompt of {out._p_len} tokens, not [sot_prev] + 32 + 4")


def route_phase(torch, E, W) -> dict:
    """Phase 3g: every decode route on whisper-small bf16, on the default
    path (4 and 64 rows x 10 s) and the fp8 path with both kernels (4 rows
    x 30 s); returns the launch counts of all its groups."""
    from stt_tpu_torch import bench as B

    totals = {"mel_logspec": 0, "xattn_decode": 0, "flash_attention": 0, "cross_logits": 0,
              "cross_mix": 0}
    paths = [("int8 cross K/V, einsum",
              dict(cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off"), 10.0, (4, 64)),
             ("fp8 cross K/V, both kernels",
              dict(cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto"), 30.0, (4,))]
    for tag, policy, seconds, sizes in paths:
        engine = E.WhisperEngine("small", device="cuda", compute_type="bfloat16",
                                 batch_buckets=(1, 4, 16, 64), max_decode_tokens=224,
                                 draft_mode="on", **policy)
        twin = TwinDecodes(torch, engine)
        cfg = engine.config
        try:
            routes = route_options(engine)
            t0 = time.monotonic()
            engine.prewarm([seconds], list(sizes), beam_sizes=[1, BEAM])
            log(f"routes ({tag}): prewarmed the plain entries at {seconds:g} s x "
                f"{'/'.join(map(str, sizes))} rows, beams 1 and {BEAM}, in "
                f"{time.monotonic() - t0:.2f} s ({engine.graph_captures} captures)")
            for rows in sizes:
                twin.on = rows == 4
                for name, opts in routes.items():
                    captures = engine.graph_captures
                    for tick in range(2 if name == "prompt-drafted" else 1):
                        drafted0 = engine.draft_stats["rows"]
                        torch.cuda.synchronize()
                        t0 = time.monotonic()
                        tasks, (outs, counts) = route_group(E, W, engine, name, opts,
                                                            seconds, rows, tick)
                        torch.cuda.synchronize()
                        wall = time.monotonic() - t0
                        check_route(W, engine, name, opts, tasks, outs)
                        for k in totals:
                            totals[k] += counts[k]
                        encodes = counts["mel_logspec"]
                        # a drafted tick whose every row accepts its draft to the
                        # budget finishes in the verify pass, with no replay
                        if encodes != (2 if opts is LADDER else 1) or (
                                counts["graph_replays"] <= 0 and not tick):
                            fail(f"routes ({tag}, {name}, {rows} rows): launches {counts}")
                        flash_on = engine.policy.flash_on(1500) and seconds == 30.0
                        if counts["flash_attention"] != (cfg.n_audio_layer * encodes
                                                         if flash_on else 0):
                            fail(f"routes ({tag}, {name}): flash_attention launched "
                                 f"{counts['flash_attention']} times for {encodes} encodes")
                        if counts["xattn_decode"] != (cfg.n_text_layer * counts["decoder_steps"]
                                                      if engine.policy.xattn_on else 0):
                            fail(f"routes ({tag}, {name}): xattn_decode launched "
                                 f"{counts['xattn_decode']} times for "
                                 f"{counts['decoder_steps']} decoder steps")
                        if name == "prompt-drafted" and tick and (
                                engine.draft_stats["rows"] <= drafted0):
                            fail(f"routes ({tag}): the second tick of partials was not drafted")
                    log(f"routes ({tag}, {name}, {rows} x {seconds:g} s): {wall:.3f} s, "
                        f"{engine.graph_captures - captures} captures at first use, launches "
                        f"{ {k: counts[k] for k in ('mel_logspec', 'xattn_decode', 'flash_attention', 'graph_replays')} }, "
                        f"lengths {[o._n_gen for o in outs[:4]]}, temperatures "
                        f"{sorted({o.temperature_used for o in outs})}")
            twin.on = False
            torch.cuda.synchronize()
            t0 = time.monotonic()
            route_group(E, W, engine, "ladder", LADDER, seconds, max(sizes), 1)
            torch.cuda.synchronize()
            ladder_ms = (time.monotonic() - t0) * 1e3
            want = {"greedy", "drafted", "sampled", "timestamps", f"timestamps, beam {BEAM}",
                    "penalised, ngram 3", f"penalised, ngram 3, beam {BEAM}"}
            missing = want | {route_name(k) for k in twin.calls if k.rows == 4}
            missing -= set(twin.checked)
            if missing:
                fail(f"routes ({tag}): no captured-vs-uncaptured check for {sorted(missing)}")
            log(f"routes ({tag}): every route's replays bitwise its uncaptured chunk at 4 rows "
                f"({twin.checked})")
            sampled = [v for k, v in twin.calls.items() if k.route.sampled and k.rows == 4]
            entry, args, kwargs = sampled[0]
            with engine._device_lock, torch.inference_mode():
                seeded = [twin.real(entry, *args, **{**kwargs, "seed": s}).tokens
                          for s in (7, 7, 8)]
            if not torch.equal(seeded[0], seeded[1]) or torch.equal(seeded[0], seeded[2]):
                fail(f"routes ({tag}): two sampled decodes at seed 7 differ, or seeds 7 and 8 "
                     f"agree")
            log(f"routes ({tag}): two sampled decodes at one seed equal, two seeds differ")
            log(f"routes ({tag}): one full ladder (temperatures {LADDER['temperature']}, "
                f"best_of {LADDER['best_of']}, every row failing) on {max(sizes)} x "
                f"{seconds:g} s, its entries built: {ladder_ms:.1f} ms, wall clock with the "
                f"host's reads")
            if 64 in sizes:
                greedy = B.decode_step_ms(engine, seconds, 64, captured=True)
                for e in engine.graphs.entries():
                    if e.key.rows != 64 or e.graph is None or route_name(e.key) in (
                            "greedy", f"beam {BEAM}") and e.key.p_len != B.PROMPT_LEN:
                        continue
                    ms = {c: B.decode_step_ms(engine, seconds, 64, captured=c, entry=e)
                          for c in (True, False)}
                    log(f"route step ({route_name(e.key)}, 64 x {seconds:g} s, p_len "
                        f"{e.key.p_len}): captured {ms[True]:.4f} ms, eager {ms[False]:.4f} ms, "
                        f"{ms[True] / greedy:.2f} x the greedy step ({greedy:.4f} ms)")
            log(f"routes ({tag}): {len(engine.graphs)} entries, "
                f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        finally:
            engine.close()
    return totals


class HashedGumbel:
    """Stands in for ``gumbel_noise`` in the float32 reference: Gumbel
    draws from an exact integer hash of (seed, draw, element), equal on the
    card and the CPU (whose Philox streams differ), with the seed and the
    draw counter in device tensors so a captured chunk draws anew at each
    replay and a reseed reaches it."""

    def __init__(self, torch, W) -> None:
        self.torch, self.W, self.state = torch, W, {}
        self.real_reset, self.real_noise = W.reset_rules, W.gumbel_noise

    def __enter__(self):
        def reset(rules, *args, **kwargs):
            self.real_reset(rules, *args, **kwargs)
            if rules.temperature is not None:
                seed, count = self._of(rules.generator)
                seed.fill_(kwargs["seed"])
                count.zero_()

        self.W.reset_rules, self.W.gumbel_noise = reset, self
        return self

    def __exit__(self, *exc) -> None:
        self.W.reset_rules, self.W.gumbel_noise = self.real_reset, self.real_noise

    def _of(self, generator):
        torch = self.torch
        if id(generator) not in self.state:
            self.state[id(generator)] = tuple(
                torch.zeros((), dtype=torch.long, device=generator.device) for _ in range(2))
        return self.state[id(generator)]

    def __call__(self, shape, generator):
        torch = self.torch
        seed, count = self._of(generator)
        n = int(np.prod(shape))
        x = (torch.arange(n, device=generator.device) + count * n + seed * 7919) % 2147483647
        for _ in range(3):  # Park-Miller steps: below 2**47, exact in int64
            x = (x * 48271 + 12345) % 2147483647
        count.add_(1)
        u = (x.float() / 2147483647.0).clamp(1e-7, 1.0 - 1e-7)
        return -torch.log(-torch.log(u)).view(shape)


def timestamp_ties_bf16(torch, E, W) -> None:
    """Phase 3g's bf16 timestamp check: greedy timestamp decodes of the
    ``test`` model in bfloat16 on the card and on the CPU (plain versions),
    4 requests of 0.7-1.9 s. A row whose tokens differ must differ at a
    near-tie of the card's decode: its steps rerun uncaptured along the
    common prefix, the grammar's state advanced token by token, at the first
    differing position either the top-2 gap of the card's final logits or
    the sum-probability rule's margin (timestamp log-mass against the best
    text token, before the grammar's state masks) under ``BF16_TIE_GAP``."""
    opts = {"without_timestamps": False}
    clips = [(1.9, "en"), (1.5, None), (1.2, "en"), (0.7, None)]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = E.WhisperEngine("test", device=device, compute_type="bfloat16")
        tasks = [E._Task(E.DecodeRequest(synth_audio(secs, seed=50 + i), language=lang,
                                         options=dict(opts)), None)
                 for i, (secs, lang) in enumerate(clips)]
        ctx = eng._device_phase(tasks)
        outs[device] = (eng, ctx, eng._harvest(ctx))
        eng.close()
    eng, ctx, card = outs["cuda"]
    cpu = outs["cpu"][2]
    dec, dev, eot = eng.model.decoder, eng.device, eng.layout.eot
    p_len = ctx["p_len"]
    rows = [np.asarray(o._tokens[: o._p_len + o._n_gen]) for o in card]
    first = {}
    for i, (a, o) in enumerate(zip(rows, cpu)):
        b = np.asarray(o._tokens[: o._p_len + o._n_gen])
        n = lcp(a.tolist(), b.tolist())
        if n < max(len(a), len(b)):
            first[i] = n
    gaps = {}
    if first:
        tokens = torch.zeros((ctx["batch_n"], p_len + eng._max_new_for(ctx["bucket_sec"])),
                             dtype=torch.long, device=dev)
        for i, a in enumerate(rows):
            tokens[i, : len(a)] = torch.from_numpy(a).to(dev)
        key = eng.graphs.key(ctx["bucket_sec"], ctx["batch_n"], p_len,
                             eng._max_new_for(ctx["bucket_sec"]))
        st = W.init_decode_state(eng.config, key.rows, p_len, key.max_new, eng._dtype, dev,
                                 route=W.Route(timestamps=True))
        is_ts = torch.arange(eng.config.n_vocab, device=dev) >= eng.layout.timestamp_begin
        with torch.inference_mode():
            enc = E._mel_encode(eng.model, ctx["rows_dev"], eng._dtype)
            ckv = W.precompute_cross_kv(dec, enc)
            W.start_decode(dec, st, tokens[:, :p_len], st.prompt_len.fill_(p_len), ckv)
            for pos in range(p_len, max(first.values()) + 1):
                raw = W._decoder_step(dec, tokens[:, pos - 1], pos - 1, st.cache, ckv)
                raw = raw + st.suppress + torch.where((st.prompt_len == pos)[:, None],
                                                      st.begin, 0.0)
                logits = W._ts_apply(st.rules, raw, st.pos.fill_(pos) - p_len)
                for row, at in first.items():
                    if at == pos:
                        top = torch.topk(logits[row], 2).values
                        lp = torch.log_softmax(raw[row], dim=-1)
                        margin = (torch.logsumexp(lp[is_ts], 0) - lp[~is_ts].max()).abs()
                        gaps[row] = min(float(top[0] - top[1]), float(margin))
                W._advance_rules(st.rules, tokens[:, pos],
                                 torch.ones(key.rows, dtype=torch.bool, device=dev), eot)
    wide = {r: g for r, g in gaps.items() if not g < BF16_TIE_GAP}
    if wide:
        fail(f"timestamps bf16: rows {sorted(wide)} differ from the CPU's at gaps {wide}, not "
             f"near-ties")
    log(f"timestamps bf16 (test model, card vs CPU, {len(rows)} rows): "
        f"{len(rows) - len(first)} rows identical"
        + (f"; rows {sorted(first)} differ first at positions "
           f"{[first[r] for r in sorted(first)]}, near-ties of the card's decode (gaps "
           f"{[round(gaps[r], 5) for r in sorted(first)]})" if first else ""))


def route_reference_f32(torch, E, W) -> None:
    """Phase 3g's float32 gate: the ``test`` model on the card against the
    CPU, every route on 2 requests (1.5 s en, 0.7 s detected), with the
    ladder's draws from :class:`HashedGumbel` on both: the same tokens,
    generated counts, temperatures and texts."""
    outs = {}
    with HashedGumbel(torch, W):
        for device in ("cuda", "cpu"):
            engine = E.WhisperEngine("test", device=device, compute_type="float32",
                                     batch_buckets=(1, 4, 16, 64), draft_mode="on")
            try:
                got = {}
                for name, opts in route_options(engine).items():
                    for tick in range(2 if name == "prompt-drafted" else 1):
                        tasks = []
                        for i, (secs, lang) in enumerate(((1.5, "en"), (0.7, None))):
                            tasks.append(E._Task(E.DecodeRequest(
                                synth_audio(secs, seed=10 + i), language=lang,
                                options=dict(opts), session_id=f"ref-{name}-{i}",
                                is_final=name != "prompt-drafted"), None))
                            engine._attach_draft(tasks[-1])
                        res = engine._harvest(engine._device_phase(tasks))
                        got[f"{name}/{tick}"] = [
                            (o._tokens[: o._p_len + o._n_gen].tolist(), o.temperature_used,
                             [s.text for s in o.segments]) for o in res]
                outs[device] = got
            finally:
                engine.close()
    differ = [k for k in outs["cpu"] if outs["cuda"][k] != outs["cpu"][k]]
    if differ:
        fail(f"routes f32: the card's outputs differ from the CPU's on {differ}: "
             f"{[outs['cuda'][k][0][:2] for k in differ][:1]} vs "
             f"{[outs['cpu'][k][0][:2] for k in differ][:1]}")
    log(f"routes f32 (test model, card vs CPU, {len(outs['cpu'])} groups): every route's "
        f"tokens, temperatures and texts equal (ladder temperatures "
        f"{[t for _, t, _ in outs['cpu']['ladder/0']]})")


# -- phase 3h: long finals, word timestamps, checkpoints ---------------------------

LONG_SEC = 75.0      # two full 30 s windows and a 15 s tail
WORDS = {"word_timestamps": True, "no_speech_threshold": None}


class WindowLog:
    """Records each seek window an engine decodes (its samples and output)
    by wrapping the engine's ``_decode_window``."""

    def __init__(self, engine) -> None:
        self.engine, self.real, self.windows = engine, engine._decode_window, []

    def __enter__(self):
        def spy(sub, cancel_event):
            out = self.real(sub, cancel_event)
            self.windows.append((len(sub.audio), out))
            return out

        self.engine._decode_window = spy
        return self

    def __exit__(self, *exc) -> None:
        del self.engine._decode_window


def check_long(tag: str, out, windows, n_samples: int, win: int, with_ts: bool) -> None:
    """A long final against its windows: each window starts where the seek
    loop's rule puts it (the end of a full window's last closed segment in
    timestamp mode, else the window's end; at least one second on), the
    windows cover the audio, and the final's segments are the windows'
    shifted by their offsets, global and monotone inside the audio."""
    seek, expect = 0, []
    for n, w_out in windows:
        if n != min(win, n_samples - seek):
            fail(f"long final ({tag}): a window of {n} samples at {seek}")
        expect += [(s.start + seek / 16000, s.end + seek / 16000, s.text)
                   for s in w_out.segments]
        advance = n
        if with_ts and w_out.segments and n == win:
            last_end = w_out.segments[-1].end
            if 0.0 < last_end < n / 16000:
                advance = int(last_end * 16000)
        seek += max(advance, 16000)
    got = [(s.start, s.end, s.text) for s in out.segments]
    if seek < n_samples or got != expect:
        fail(f"long final ({tag}): windows end at {seek} of {n_samples} samples, or the "
             f"segments {got[:3]} are not the windows' {expect[:3]}")
    starts = [s[0] for s in got]
    if not got or starts != sorted(starts) or not all(
            0.0 <= a <= b <= n_samples / 16000 + 1e-6 for a, b, _ in got):
        fail(f"long final ({tag}): segments not global and monotone: {got}")


def timed_word_pass(torch, engine) -> dict:
    """Wraps the engine's word-timestamp pass to record its wall time and
    the device memory it takes above what was allocated before it."""
    real, stats = engine._word_timestamp_pass, {}

    def timed(ctx, outputs, wt_rows):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        real(ctx, outputs, wt_rows)
        torch.cuda.synchronize()
        stats.update(sec=time.monotonic() - t0, rows=len(wt_rows),
                     peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)

    engine._word_timestamp_pass = timed
    return stats


def word_group(torch, E, W, engine, tag: str, seconds: list, seed: int) -> dict:
    """One group with ``word_timestamps`` (a row per entry of ``seconds``):
    every row with text has words, monotone inside its duration. Prints the
    pass's time and memory; returns the group's launch counts."""
    stats = timed_word_pass(torch, engine)
    tasks = [E._Task(E.DecodeRequest(synth_audio(s, seed=seed + i), language="en",
                                     options=dict(WORDS)), None) for i, s in enumerate(seconds)]
    try:
        outs, counts = counted_run(W, engine, lambda: engine._harvest(engine._device_phase(tasks)))
    finally:
        del engine._word_timestamp_pass
    n_words = 0
    for out, secs in zip(outs, seconds):
        starts = [w[0] for w in out.words]
        if (out.segments and not out.words) or starts != sorted(starts) or not all(
                0.0 <= a <= b <= secs + 1e-6 for a, b, _ in out.words):
            fail(f"words ({tag}): a row of {secs:g} s gave {out.words[:4]} for "
                 f"{len(out.segments)} segments")
        n_words += len(out.words)
    if not stats or counts["mel_logspec"] != 2:
        fail(f"words ({tag}): the pass did not run once after one encode: {stats}, {counts}")
    log(f"words ({tag}, {len(seconds)} x {max(seconds):g} s): pass {stats['sec']:.3f} s for "
        f"{stats['rows']} rows ({stats['sec'] / len(seconds) * 1e3:.2f} ms a row), "
        f"{stats['peak_gib']:.3f} GiB device memory above the engine's, {n_words} words; "
        f"launches {({k: counts[k] for k in ('mel_logspec', 'xattn_decode', 'flash_attention')})}")
    return counts


def long_words_phase(torch, E, W) -> dict:
    """Phase 3h on whisper-small bf16: long finals, word timestamps and the
    checkpoint loader; returns the launch counts of its served runs."""
    import os
    import tempfile

    from stt_tpu_torch import convert
    from stt_tpu_torch.parallel.checkpoint import export_hf_safetensors

    totals = {"mel_logspec": 0, "xattn_decode": 0, "flash_attention": 0, "cross_logits": 0,
              "cross_mix": 0}

    def add(counts: dict) -> None:
        for k in totals:
            totals[k] += counts[k]

    win = 30 * 16000
    long_audio = synth_audio(LONG_SEC, seed=70)
    n_long = len(long_audio)
    kw = dict(device="cuda", compute_type="bfloat16", batch_buckets=(1, 4, 16, 64),
              max_decode_tokens=224)
    default = dict(cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off")

    # -- the default path: a conditioned long final beside 4 partials ----------
    engine = E.WhisperEngine("small", **kw, **default)
    try:
        t0 = time.monotonic()
        engine.prewarm([5.0, 10.0, 30.0], [1, 4])
        engine.prewarm([10.0], [64])
        captures0 = engine.graph_captures
        log(f"long (int8): prewarmed 5/10/30 s x 1/4 rows and 10 s x 64 in "
            f"{time.monotonic() - t0:.2f} s ({captures0} captures)")
        final = E.DecodeRequest(long_audio, language="en", is_final=True, session_id="long",
                                options={"no_speech_threshold": None})
        partials = [E.DecodeRequest(synth_audio(5.0, seed=71 + i), language="en",
                                    session_id=f"p{i}") for i in range(4)]
        done = {}

        def run():
            futs = {"final": engine.submit(final)}
            futs.update({f"p{i}": engine.submit(r) for i, r in enumerate(partials)})
            for name, fut in futs.items():
                fut.add_done_callback(lambda f, name=name: done.setdefault(name, time.monotonic()))
            return {name: fut.result(timeout=300) for name, fut in futs.items()}

        with WindowLog(engine) as wl:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            outs, counts = counted_run(W, engine, run)
        add(counts)
        check_long("int8", outs["final"], wl.windows, n_long, win, with_ts=False)
        late = [n for n in done if n != "final" and done[n] >= done["final"]]
        if len(wl.windows) != 3 or late or counts["mel_logspec"] < 4:
            fail(f"long (int8): {len(wl.windows)} windows, partials {late} resolved after the "
                 f"final, launches {counts}")
        log(f"long (int8, {LONG_SEC:g} s final beside 4 x 5 s partials): {len(wl.windows)} "
            f"windows, final {done['final'] - t0:.3f} s, partials "
            f"{max(done[n] for n in done if n != 'final') - t0:.3f} s; conditioned windows "
            f"captured {engine.graph_captures - captures0} entries while serving, "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved; launches "
            f"{({k: counts[k] for k in totals})}, {len(outs['final'].segments)} segments")

        add(word_group(torch, E, W, engine, "int8", [6.0 + 4.0 * (i % 8) / 7 for i in range(64)],
                       seed=100))

        # -- the loader: the same weights through a checkpoint --------------------
        with tempfile.TemporaryDirectory(prefix="smoke_ckpt_") as tmp:
            t0 = time.monotonic()
            n_bytes = export_hf_safetensors(
                tmp, convert.to_jax_params(engine.model.state_dict()), engine.config,
                dtype=torch.bfloat16)
            write_s = time.monotonic() - t0
            os.environ["STT_ALLOW_FALLBACK_TOKENIZER"] = "1"
            try:
                loaded = E.WhisperEngine("small", weights_path=tmp, **kw, **default)
            finally:
                del os.environ["STT_ALLOW_FALLBACK_TOKENIZER"]
            try:
                rows = [(synth_audio(10.0 - i, seed=120 + i), lang)
                        for i, lang in enumerate(("en", None, "de", "en"))]
                got = []
                for eng in (loaded, engine):
                    tasks = [E._Task(E.DecodeRequest(a, language=lang), None) for a, lang in rows]
                    got.append([o._tokens[: o._p_len + o._n_gen].tolist()
                                for o in eng._harvest(eng._device_phase(tasks))])
            finally:
                loaded.close()
        if got[0] != got[1]:
            fail("loader: the checkpoint's engine decodes other tokens than the seeded one")
        log(f"loader: wrote {n_bytes} bytes (bf16) in {write_s:.2f} s; the engine from "
            f"weights_path loaded in {loaded.load_seconds:.2f} s; greedy tokens at 4 x 10 s "
            f"equal the seeded engine's")
    finally:
        engine.close()

    # -- fp8 cross K/V with both kernels: a timestamp long final, words at 30 s --
    engine = E.WhisperEngine("small", **kw, cross_kv_dtype="fp8", xattn_kernel="mm",
                             flash_attention="auto")
    cfg = engine.config
    try:
        engine.prewarm([30.0], [1, 4])
        final = E.DecodeRequest(long_audio, language="en", is_final=True,
                                options={"without_timestamps": False,
                                         "no_speech_threshold": None}, session_id="long-ts")
        with WindowLog(engine) as wl:
            t0 = time.monotonic()
            out, counts = counted_run(W, engine, lambda: engine.submit(final).result(timeout=300))
            wall = time.monotonic() - t0
        add(counts)
        check_long("fp8, timestamps", out, wl.windows, n_long, win, with_ts=True)
        if (counts["flash_attention"] != cfg.n_audio_layer * len(wl.windows)
                or counts["xattn_decode"] != cfg.n_text_layer * counts["decoder_steps"]):
            fail(f"long (fp8): launches {counts} for {len(wl.windows)} windows")
        log(f"long (fp8, both kernels, timestamps, {LONG_SEC:g} s): {len(wl.windows)} windows "
            f"at {[round(n / 16000, 2) for n, _ in wl.windows]} s, {wall:.3f} s, "
            f"{len(out.segments)} segments; launches "
            f"{({k: counts[k] for k in (*totals, 'decoder_steps')})}")
        counts = word_group(torch, E, W, engine, "fp8, both kernels", [24.0, 26.0, 28.0, 30.0],
                            seed=130)
        if counts["flash_attention"] != 2 * cfg.n_audio_layer:
            fail(f"words (fp8): flash launched {counts['flash_attention']} times for 2 encodes")
        add(counts)
    finally:
        engine.close()

    # -- float32 test model: the card against the CPU ------------------------------
    outs = {}
    for device in ("cuda", "cpu"):
        eng = E.WhisperEngine("test", device=device, compute_type="float32",
                              batch_buckets=(1, 4))
        try:
            outs[device] = eng.transcribe_sync(E.DecodeRequest(
                synth_audio(65.0, seed=140), language="en", is_final=True,
                options={**WORDS, "without_timestamps": False}))
        finally:
            eng.close()
    card, host = outs["cuda"], outs["cpu"]
    seg = [[(s.start, s.end, s.text) for s in o.segments] for o in (card, host)]
    gaps = [max(abs(a[0] - b[0]), abs(a[1] - b[1])) for a, b in zip(card.words, host.words)]
    if (seg[0] != seg[1] or not host.words or [w[2] for w in card.words] != [w[2] for w in host.words]
            or max(gaps) > 0.02 + 1e-9):
        fail(f"long f32 (test model, card vs CPU): segments equal {seg[0] == seg[1]}, words "
             f"{card.words[:4]} vs {host.words[:4]}")
    log(f"long f32 (test model, 65 s, timestamps and words, card vs CPU): {len(seg[0])} "
        f"segments equal, {len(host.words)} words equal in text, times within "
        f"{max(gaps):.3f} s")
    return totals


# -- phase 3i: the decoder policies, any decode bound, use_pallas false -------------

POLICY_SWITCHES = ("STT_DECODER_WEIGHTS_DTYPE", "STT_FUSED_QKV", "STT_SELF_KV_DTYPE",
                   "STT_PREFILL", "STT_DRAFT_PARTIALS")
POLICIES = {
    "int8": {"STT_DECODER_WEIGHTS_DTYPE": "int8"},
    "int8_native": {"STT_DECODER_WEIGHTS_DTYPE": "int8_native"},
    "fused": {"STT_FUSED_QKV": "on"},
    "fp8_self": {"STT_SELF_KV_DTYPE": "fp8"},
    "seq": {"STT_PREFILL": "seq"},
    "fused_int8": {"STT_FUSED_QKV": "on", "STT_DECODER_WEIGHTS_DTYPE": "int8"},
}
POLICY_LOGITS_ATOL = 0.05    # the bf16 bound of tests/test_torch_policies.py
# 8-bit storage against the bf16 engine: the JAX package's own bars, relative
# to the largest |logit| (at least 1), tests/test_quant_weights.py:97 (int8
# weights, also taken for the fp8 self cache, its other 8-bit storage) and
# :259 (int8_native)
STORAGE_LOGITS_REL = {"int8": 0.06, "int8_native": 0.12, "fp8": 0.06}
# int8_native against its own model on the CPU: it re-quantizes every
# activation a row at a time, so a bf16 rounding difference upstream can move
# a code across a rounding edge; twice the bf16 bound, the ratio of the JAX
# package's native and int8 bars
NATIVE_CPU_ATOL = 2 * POLICY_LOGITS_ATOL
QUANT_AGREEMENT_BAR = 0.6    # tests/test_quant_weights.py:106, seed-averaged, tiny model
BOUND = 100                  # a max_decode_tokens off the 8-step chunk
COND_PROMPT = 223            # a conditioned window's context: the half-context budget


class Switches:
    """The decoder-policy switches (and ``STT_DRAFT_PARTIALS``) for a
    block: every one unset, then ``values`` set; restored after."""

    def __init__(self, values: dict) -> None:
        self.values = values

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in POLICY_SWITCHES}
        for k in POLICY_SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


class SeededParams:
    """``W.init_params`` memoised per (preset, seed) for a block, so the
    block's engines draw their seed-0 weights once (the draws are the same
    numbers every time)."""

    def __init__(self, W) -> None:
        self.W = W

    def __enter__(self):
        real, memo = self.W.init_params, {}

        def cached(config, seed=0):
            key = (config.name, seed)
            if key not in memo:
                memo[key] = real(config, seed=seed)
            return memo[key]

        self.real = real
        self.W.init_params = cached
        return self

    def __exit__(self, *exc):
        self.W.init_params = self.real
        return False


def release(engine) -> None:
    """Close an engine and give its device memory back."""
    import gc

    import torch

    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def small_engine(E, **kw):
    """whisper-small bf16 on the default attention path (int8 cross K/V,
    einsum attention) with ``kw``."""
    opts = dict(device="cuda", compute_type="bfloat16", batch_buckets=(4, 16, 64),
                cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off",
                draft_mode="off")
    opts.update(kw)
    return E.WhisperEngine("small", **opts)


def group_tasks(E, seconds: float, rows: int, seed: int, options=None, prefix: str = ""):
    """``rows`` requests of 60-100% of ``seconds`` (one bucket), language
    en, as tasks; with ``prefix`` each gets a session id."""
    return [E._Task(E.DecodeRequest(
        synth_audio(seconds * (0.6 + 0.4 * i / max(1, rows - 1)), seed=seed + i % 8),
        language="en", options=dict(options or {}),
        session_id=f"{prefix}{i}" if prefix else ""), None) for i in range(rows)]


def group_pcm(E, engine, seconds: float, rows: int, seed: int) -> np.ndarray:
    """The int16 rows (one bucket wide) of :func:`group_tasks`'s audio."""
    bucket = engine._bucket_for(int(seconds * 16000))
    pcm = np.zeros((rows, int(bucket * 16000)), np.int16)
    for i in range(rows):
        audio = synth_audio(seconds * (0.6 + 0.4 * i / max(1, rows - 1)), seed=seed + i % 8)
        pcm[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    return pcm


def encoder_states(torch, E, engine, pcm: np.ndarray):
    """The engine's encoder output for ``pcm`` (int16 rows of one bucket)."""
    with engine._device_lock, torch.inference_mode():
        rows_dev = torch.from_numpy(E._encode_wire_rows(pcm, engine.audio_wire)).to(engine.device)
        return E._mel_encode(engine.model, rows_dev, engine._dtype, engine.use_pallas)


def step_logits(torch, W, model, enc):
    """float32 logits (rows, V) of the decode step at the last prompt
    position after the prefill of the sot sequence (language en), from the
    encoder output ``enc`` on ``model``'s device: the cross K/V in its
    storage, the self cache in its decoder policy's, the prefill and the
    step as the policy says."""
    dev = enc.device
    rows = enc.shape[0]
    prompt = np.array([W.build_prompt(model.config, "en")] * rows, np.int64)
    dec = model.decoder
    with torch.inference_mode():
        ckv = W.precompute_cross_kv(dec, enc)
        p_len = prompt.shape[1]
        cache = W.init_kv_cache(model.config, rows, p_len + 8,
                                dec.decoder_policy.cache_dtype(enc.dtype), dev)
        toks = torch.from_numpy(prompt).to(dev)
        W._prefill(dec, toks, p_len, cache, ckv, 0, W.token_layout(model.config.n_vocab))
        return W._decoder_step(dec, toks[:, -1], p_len - 1, cache, ckv).float().cpu()


def cpu_step_logits(torch, W, engine, enc, rows: int = 8):
    """:func:`step_logits` of the engine's model rebuilt on the CPU (the
    same seed-0 weights, the same policies, the plain versions) for the
    first ``rows`` rows of the card's encoder output."""
    model = W.build_model(engine.config, W.init_params(engine.config, seed=0),
                          torch.device("cpu"), engine._dtype, engine.policy,
                          engine.decoder_policy)
    try:
        return step_logits(torch, W, model, enc[:rows].cpu())
    finally:
        del model


def decoder_bytes(engine) -> int:
    """Bytes of the decoder's weights on the device, as stored."""
    dec = engine.model.decoder
    return int(sum(t.numel() * t.element_size() for t in (*dec.parameters(), *dec.buffers())))


def prefill_ms(torch, W, engine, bucket: float = 30.0) -> float:
    """Device ms of one conditioned window's prefill at ``bucket``, 1 row:
    ``[sot_prev]`` + ``COND_PROMPT`` context tokens + the sot sequence,
    through the engine's prefill policy (CUDA events, median of 5)."""
    dev = engine.device
    dec = engine.model.decoder
    layout = engine.layout
    ctx = np.random.default_rng(5).integers(100, 40000, COND_PROMPT).tolist()
    prompt = [layout.sot_prev] + ctx + W.build_prompt(engine.config, "en")
    with torch.inference_mode():
        enc = torch.randn(1, int(bucket * 50), engine.config.n_text_state,
                          device=dev).to(engine._dtype)
        ckv = W.precompute_cross_kv(dec, enc)
        cache = W.init_kv_cache(engine.config, 1, len(prompt) + 8,
                                dec.decoder_policy.cache_dtype(engine._dtype), dev)
        toks = torch.tensor([prompt], device=dev)
    return group_ms(torch, engine, lambda: W._prefill(dec, toks, len(prompt), cache, ckv,
                                                       1 + COND_PROMPT, layout), reps=2)


def f32_card_vs_cpu(E, tag: str, groups, switches=None, **engine_kw) -> None:
    """The ``test`` model in float32 on the card and on the CPU with the
    same engine options and policy switches: each group, a list of
    ((seconds, language) clips, options, ticks), through the device phase
    (ticks > 1: sessions whose later ticks ride the drafted decode); token
    rows and texts must be equal."""
    outs = {}
    with Switches(switches or {}):
        for device in ("cuda", "cpu"):
            eng = E.WhisperEngine("test", device=device, compute_type="float32",
                                  batch_buckets=(1, 4), **engine_kw)
            try:
                got = []
                for gi, (clips, opts, ticks) in enumerate(groups):
                    for _ in range(ticks):
                        tasks = []
                        for i, (secs, lang) in enumerate(clips):
                            tasks.append(E._Task(E.DecodeRequest(
                                synth_audio(secs, seed=50 + i), language=lang,
                                options=dict(opts),
                                session_id=f"f32-{gi}-{i}" if ticks > 1 else ""), None))
                            eng._attach_draft(tasks[-1])
                        res = eng._harvest(eng._device_phase(tasks))
                        got.append([(o._tokens[: o._p_len + o._n_gen].tolist(),
                                     [s.text for s in o.segments]) for o in res])
                outs[device] = got
                policy = eng.decoder_policy
            finally:
                eng.close()
    differ = [i for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])) if a != b]
    if differ or len(outs["cuda"]) != len(outs["cpu"]):
        fail(f"{tag} f32 (test model, card vs CPU): groups {differ} differ: "
             f"{[outs['cuda'][i][0][0][:12] for i in differ][:1]} vs "
             f"{[outs['cpu'][i][0][0][:12] for i in differ][:1]}")
    log(f"{tag} f32 (test model, card vs CPU, {policy}): {len(outs['cpu'])} groups, every "
        f"token row and text equal (generated "
        f"{[len(r[0]) for g in outs['cpu'] for r in g]} tokens with the prompts)")


def no_pallas_phase(torch, E, W, M, base) -> dict:
    """Item 8 of phase 3i: ``use_pallas=False`` on the card. A whisper-small
    engine so built serves a 16 x 10 s group with no log-mel kernel launch
    while ``base`` (the default engine, prewarmed at 16 rows) launches it
    once for the same group; the plain log-mel of the group's rows is
    within the kernel's tolerance of the kernel's; the ``test`` model in
    float32 at ``use_pallas=False`` gives the CPU's tokens."""
    from stt_tpu_torch.ops.kernels.mel import mel_logspec

    engine = small_engine(E, batch_buckets=(16,), use_pallas=False)
    try:
        engine.prewarm([10.0], [16])
        captures = engine.graph_captures
        tasks = group_tasks(E, 10.0, 16, seed=60)
        outs, counts = counted_run(W, engine, lambda: engine._harvest(engine._device_phase(tasks)))
        if counts["mel_logspec"] != 0 or engine.graph_captures != captures:
            fail(f"use_pallas=False: {counts['mel_logspec']} log-mel kernel launches, "
                 f"{engine.graph_captures - captures} captures while serving")
        base_outs, base_counts = counted_run(
            W, base, lambda: base._harvest(base._device_phase(group_tasks(E, 10.0, 16, 60))))
        if base_counts["mel_logspec"] != 1:
            fail(f"use_pallas=False: the default engine launched the log-mel kernel "
                 f"{base_counts['mel_logspec']} times for the same group, not once")
        pcm = group_pcm(E, engine, 10.0, 16, 60)
        rows = torch.from_numpy(E._encode_wire_rows(pcm, "mulaw")).cuda()
        with torch.inference_mode():
            plain = M.normalize_log_mel(M.log_mel_raw(M.expand_wire(rows), 80))
            kernel = M.normalize_log_mel(mel_logspec(rows, 80))
            ms = {"plain": cuda_ms(torch, lambda: M.log_mel_raw(M.expand_wire(rows), 80)),
                  "kernel": cuda_ms(torch, lambda: mel_logspec(rows, 80))}
        err = (plain - kernel).abs().max().item()
        try:
            torch.testing.assert_close(plain, kernel, atol=MEL_ATOL, rtol=MEL_RTOL)
        except AssertionError as exc:
            fail(f"use_pallas=False: the plain log-mel disagrees with the kernel: {exc}")
        same = float(np.mean([np.array_equal(a._tokens, b._tokens)
                              for a, b in zip(outs, base_outs)]))
    finally:
        release(engine)
    f32_card_vs_cpu(E, "use_pallas=False", [([(1.5, "en"), (0.7, None)], {}, 1),
                                            ([(8.0, "en")], {"beam_size": 5}, 1)],
                    use_pallas=False)
    log(f"use_pallas=False (whisper-small bf16, 16 x 10 s): 0 log-mel kernel launches, the "
        f"default engine 1 for the same group; plain log-mel vs kernel max abs err "
        f"{err:.3g} (limit {MEL_ATOL:g} / {MEL_RTOL:g}); plain {ms['plain']:.4f} ms, kernel "
        f"{ms['kernel']:.4f} ms back to back; {same:.0%} of the rows' tokens identical to "
        f"the kernel path's")
    return {"plain_ms": ms["plain"], "kernel_ms": ms["kernel"], "err": err}


def policy_phase(torch, E, W, M, card: str) -> dict:
    """Phase 3i, items 8 and 11: the default bf16 engine (64 x 10 s greedy,
    4 x 10 s at beam 5), ``use_pallas=False`` (:func:`no_pallas_phase`),
    then each decoder policy of ``POLICIES`` on an engine of its own: the
    switches read at build, a 64 x 10 s greedy group and a beam-5 group of
    4 served with no capture, the captured greedy and beam chunks bitwise
    their uncaptured runs; one decode step's logits on the card within
    ``POLICY_LOGITS_ATOL`` of the same policy's model on the CPU (plain
    versions, 8 rows of the card's encoder output; ``NATIVE_CPU_ATOL`` for
    int8_native), and against the default engine's within
    ``POLICY_LOGITS_ATOL`` for fused and seq and within the JAX package's
    relative bars for 8-bit storage (``STORAGE_LOGITS_REL``: int8 weights,
    int8_native, the fp8 self cache), the greedy token agreement beside it; the
    captured greedy step and the beam-5 step timed, the decoder's bytes on
    the device, for ``seq`` a conditioned 30 s window's prefill; fused and
    seq also in float32 against the CPU. Every policy is measured before
    the phase fails on any. Returns the summary and the launches of the
    served groups."""
    from stt_tpu_torch import bench as B

    summary, launches, failures = {}, 0, []
    base = small_engine(E)
    try:
        if base.decoder_policy != W.DecoderPolicy():
            fail(f"policies: the default engine built {base.decoder_policy}")
        base.prewarm([10.0], [16, 64])
        base.prewarm([10.0], [4], beam_sizes=[5])
        summary["no_pallas"] = no_pallas_phase(torch, E, W, M, base)
        enc = encoder_states(torch, E, base, group_pcm(E, base, 10.0, 64, 90))
        base_logits = step_logits(torch, W, base.model, enc)
        base_cpu_err = (cpu_step_logits(torch, W, base, enc) - base_logits[:8]).abs().max().item()
        base_outs, counts = counted_run(
            W, base, lambda: base._harvest(base._device_phase(group_tasks(E, 10.0, 64, 90))))
        launches += counts["mel_logspec"]
        base_tokens = np.stack([o._tokens for o in base_outs])
        summary["bf16"] = {
            "step_ms": B.decode_step_ms(base, 10.0, 64, captured=True),
            "beam_ms": B.decode_step_ms(base, 10.0, 4, captured=True, beam=BEAM),
            "decoder_bytes": decoder_bytes(base), "cpu_logits_err": base_cpu_err,
            "prefill_ms": prefill_ms(torch, W, base),
        }
    finally:
        release(base)
    log(f"policies: the default engine's step logits on the card within {base_cpu_err:.4f} "
        f"of its model on the CPU (8 rows, bf16 both)")
    for name, switches in POLICIES.items():
        t0 = time.monotonic()
        with Switches(switches):
            engine = small_engine(E)
        try:
            pol = engine.decoder_policy
            if pol == W.DecoderPolicy():
                fail(f"policy {name}: the switches {switches} built the default policy")
            engine.prewarm([10.0], [64])
            engine.prewarm([10.0], [4], beam_sizes=[5])
            captures = engine.graph_captures
            outs, counts = counted_run(W, engine, lambda: engine._harvest(
                engine._device_phase(group_tasks(E, 10.0, 64, 90))))
            beam_outs, beam_counts = counted_run(W, engine, lambda: engine._harvest(
                engine._device_phase(group_tasks(E, 10.0, 4, 70, {"beam_size": BEAM}))))
            launches += counts["mel_logspec"] + beam_counts["mel_logspec"]
            if engine.graph_captures != captures:
                fail(f"policy {name}: {engine.graph_captures - captures} captures while serving")
            for o in outs + beam_outs:
                if not (0 < o._n_gen <= engine._max_new_for(10.0)
                        and np.isfinite(o.avg_logprob)):
                    fail(f"policy {name}: malformed output (n_gen {o._n_gen}, avg logprob "
                         f"{o.avg_logprob})")
            ms = graphs_phase(torch, E, W, engine, 10.0, 64, f"whisper-small bf16, {name}")
            beam_graphs_check(torch, E, W, engine, 10.0, 4, f"whisper-small bf16, {name}")
            logits = step_logits(torch, W, engine.model, enc)
            cpu_err = (cpu_step_logits(torch, W, engine, enc) - logits[:8]).abs().max().item()
            err = (logits - base_logits).abs().max().item()
            scale = max(base_logits.abs().max().item(), 1.0)
            storage = pol.weights if pol.int8 else pol.self_kv
            rel = STORAGE_LOGITS_REL.get(storage)
            limit = rel * scale if rel else POLICY_LOGITS_ATOL
            cpu_limit = NATIVE_CPU_ATOL if pol.native else POLICY_LOGITS_ATOL
            agree = float((np.stack([o._tokens for o in outs]) == base_tokens).mean())
            if not torch.isfinite(logits).all() or cpu_err > cpu_limit:
                failures.append(f"{name}: step logits on the card {cpu_err:.4g} from the same "
                                f"policy on the CPU (limit {cpu_limit})")
            if err > limit:
                failures.append(f"{name}: step logits {err:.4g} from the default engine's "
                                f"(limit {limit:.4g})")
            row = {
                "policy": str(pol), "step_ms": ms[True], "eager_ms": ms[False],
                "beam_ms": B.decode_step_ms(engine, 10.0, 4, captured=True, beam=BEAM),
                "decoder_bytes": decoder_bytes(engine), "logits_err": err,
                "logits_limit": limit, "cpu_logits_err": cpu_err, "cpu_limit": cpu_limit,
                "token_agreement": agree,
                "bytes_a_step": B.decode_step_bytes(engine, 10.0, 64),
            }
            if name == "seq":
                row["prefill_ms"] = prefill_ms(torch, W, engine)
            summary[name] = row
        finally:
            release(engine)
        log(f"policy {name} ({row['policy']}; {time.monotonic() - t0:.1f} s): step logits "
            f"{cpu_err:.4f} from the same policy on the CPU (limit {cpu_limit}; the default "
            f"engine's own {base_cpu_err:.4f}), {err:.4f} from the default engine's (limit "
            f"{limit:.4f}"
            + (f": {rel} of the largest |logit| {scale:.3f}, the JAX package's bar for 8-bit "
               f"storage" if rel else "") + f"), greedy token agreement "
            f"{agree:.3f} over 64 x 10 s (the JAX package's bar on its tiny model "
            f"{QUANT_AGREEMENT_BAR}); captured greedy step {row['step_ms']:.4f} ms at 64 x 10 s "
            f"(default {summary['bf16']['step_ms']:.4f}), beam-5 step {row['beam_ms']:.4f} ms at "
            f"4 x 10 s (default {summary['bf16']['beam_ms']:.4f}); decoder "
            f"{row['decoder_bytes'] / 1e6:.1f} MB on the device (default "
            f"{summary['bf16']['decoder_bytes'] / 1e6:.1f})"
            + (f"; a conditioned 30 s window's prefill ({COND_PROMPT + 5} tokens) "
               f"{row['prefill_ms']:.2f} ms (parallel {summary['bf16']['prefill_ms']:.2f})"
               if name == "seq" else "") + f" ({card})")
    if failures:
        fail("policies: " + "; ".join(failures))
    for name in ("fused", "seq"):
        f32_card_vs_cpu(E, f"policy {name}", [([(1.5, "en"), (0.7, None)], {}, 1),
                                             ([(1.2, "en"), (0.9, "en")], {"beam_size": 5}, 1),
                                             ([(1.8, "en"), (1.1, "en")], {}, 2)],
                        switches=POLICIES[name], draft_mode="on")
    return {"summary": summary, "mel_logspec": launches}


def bound_phase(torch, E, W) -> dict:
    """Phase 3i, item 9: whisper-small bf16 at ``max_decode_tokens=BOUND``
    (the 30 s bucket's bound 100: 12 chunks and a captured tail of 4). A
    4 x 30 s greedy group, a beam-5 group and two ticks of drafted
    partials served with no capture and no row past the bound; the greedy,
    beam and drafted entries' replays bitwise their uncaptured runs; the
    ``test`` model in float32 at the same bound gives the CPU's tokens."""
    engine = small_engine(E, batch_buckets=(1, 4), max_decode_tokens=BOUND, draft_mode="on")
    try:
        max_new = engine._max_new_for(30.0)
        engine.prewarm([30.0], [4], beam_sizes=[1, BEAM], include_drafted=True)
        captures = engine.graph_captures
        entry = engine.graphs.lookup(30.0, 4, 4, max_new)
        if max_new != BOUND or entry.tail != BOUND % 8 or entry.tail_graph is None:
            fail(f"bound {BOUND}: the 30 s bucket's bound {max_new}, tail {entry.tail}")
        served, launches = {}, 0
        for name, opts, prefix, ticks in (("greedy", {}, "", 1), ("beam", {"beam_size": BEAM}, "", 1),
                                          ("drafted", {}, "bound-", 2)):
            for _ in range(ticks):
                tasks = group_tasks(E, 30.0, 4, 100, opts, prefix)
                for t in tasks:
                    engine._attach_draft(t)
                outs, counts = counted_run(W, engine, lambda: engine._harvest(
                    engine._device_phase(tasks)))
                launches += counts["mel_logspec"]
            served[name] = ([o._n_gen for o in outs], counts["graph_replays"],
                            tasks[0].draft is not None)
            if any(not 0 < o._n_gen <= BOUND for o in outs):
                fail(f"bound {BOUND} ({name}): generated {[o._n_gen for o in outs]}")
        if not served["drafted"][2]:
            fail(f"bound {BOUND}: the second tick did not ride the drafted decode")
        if engine.graph_captures != captures:
            fail(f"bound {BOUND}: {engine.graph_captures - captures} captures while serving")
        graphs_phase(torch, E, W, engine, 30.0, 4, f"whisper-small bf16, bound {BOUND}")
        beam_graphs_check(torch, E, W, engine, 30.0, 4, f"whisper-small bf16, bound {BOUND}")
        plain, drafted, prompt, plen = drafted_group(torch, E, W, engine, 4, seed=110, bucket=30.0)
        with engine._device_lock, torch.inference_mode():
            base = engine.graphs.decode(plain, prompt, plen)
        draft = base.tokens[:, plain.key.p_len:].clone()
        draft[1, 20:] = (draft[1, 20:] + 7) % 1000
        dlen = base.lengths - plain.key.p_len
        got = {c: drafted_decodes(torch, engine, plain, drafted, prompt, plen, draft, dlen, c)[1]
               for c in (True, False)}
        for field in ("tokens", "lengths", "sum_logprob", "n_accepted"):
            if not torch.equal(getattr(got[True], field), getattr(got[False], field)):
                fail(f"bound {BOUND} drafted: captured and uncaptured {field} differ")
    finally:
        release(engine)
    f32_card_vs_cpu(E, f"bound {BOUND}", [([(25.0, "en"), (30.0, None)], {}, 1),
                                          ([(28.0, "en")], {"beam_size": BEAM}, 1),
                                          ([(26.0, "en"), (29.0, "en")], {}, 2)],
                    max_decode_tokens=BOUND, draft_mode="on", audio_buckets_sec=(10.0, 30.0))
    log(f"bound {BOUND} (whisper-small bf16, 4 x 30 s, {max_new // 8} chunks + a tail of "
        f"{max_new % 8}): generated {served['greedy'][0]} greedy, {served['beam'][0]} at beam "
        f"{BEAM}, {served['drafted'][0]} drafted, no capture while serving; greedy, beam and "
        f"drafted replays bitwise their uncaptured runs (drafted accepted "
        f"{got[True].n_accepted.tolist()})")
    return {"greedy": served["greedy"][0], "mel_logspec": launches}


# -- phase 3j: opt-in VAD (the batched device scorer, Silero through ONNX) ---------

VAD_ATOL = 1e-5              # tests/test_torch_vad_scorer.py, tests/test_torch_onnx.py
VAD_SESSIONS = 16


def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb(no: int, wire: int, payload) -> bytes:
    tag = _pb_varint((no << 3) | wire)
    return tag + (_pb_varint(payload) if wire == 0 else _pb_varint(len(payload)) + payload)


def _onnx_tensor(name: str, arr: np.ndarray) -> bytes:
    code = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
    msg = b"".join(_pb(1, 0, d) for d in arr.shape) + _pb(2, 0, code)
    return msg + _pb(8, 2, name.encode()) + _pb(9, 2, arr.tobytes())


def _onnx_attr(name: str, atype: int, body: bytes) -> bytes:
    return _pb(5, 2, _pb(1, 2, name.encode()) + body + _pb(20, 0, atype))


def _onnx_ints(name: str, vals) -> bytes:
    return _onnx_attr(name, 7, b"".join(_pb(8, 0, v & ((1 << 64) - 1)) for v in vals))


def _onnx_int(name: str, v: int) -> bytes:
    return _onnx_attr(name, 2, _pb(3, 0, v & ((1 << 64) - 1)))


def _onnx_node(op: str, inputs, outputs, attrs: bytes = b"") -> bytes:
    return (b"".join(_pb(1, 2, i.encode()) for i in inputs)
            + b"".join(_pb(2, 2, o.encode()) for o in outputs) + _pb(4, 2, op.encode()) + attrs)


def _onnx_graph(nodes, inits, inputs, outputs) -> bytes:
    def value_info(name, shape=None):
        msg = _pb(1, 2, name.encode())
        if shape is not None:
            dims = b"".join(_pb(1, 2, _pb(2, 2, b"B") if d is None else _pb(1, 0, d))
                            for d in shape)
            msg += _pb(2, 2, _pb(1, 2, _pb(1, 0, 1) + _pb(2, 2, dims)))
        return msg

    return (b"".join(_pb(1, 2, n) for n in nodes) + b"".join(_pb(5, 2, t) for t in inits)
            + b"".join(_pb(11, 2, value_info(n, s)) for n, s in inputs)
            + b"".join(_pb(12, 2, value_info(o)) for o in outputs))


def silero_v5_shaped(path: Path, seed: int = 0, hidden: int = 128) -> str:
    """A graph with the published Silero v5 signature, hand-encoded with
    seeded weights: ``input`` [B, 576] (64 context samples + a 512 frame),
    ``state`` [2, B, 128] (h and c), ``sr``, an ``If`` on the sample rate
    (16 kHz scales the window by 1, else by 0.5), a strided conv feature
    stack, one LSTM step, a linear head and a sigmoid; outputs the speech
    probability and the new state."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return rng.normal(0, scale, shape).astype(np.float32)

    def branch(const, value):
        return _onnx_graph([_onnx_node("Mul", ["input", const], ["x_sr"])],
                           [_onnx_tensor(const, np.asarray(value, np.float32))], [], ["x_sr"])

    if_attrs = (_onnx_attr("then_branch", 5, _pb(6, 2, branch("one", 1.0)))
                + _onnx_attr("else_branch", 5, _pb(6, 2, branch("half", 0.5))))
    g = _onnx_graph(
        nodes=[
            _onnx_node("Equal", ["sr", "sr16"], ["is16"]),
            _onnx_node("If", ["is16"], ["x_sr"], if_attrs),
            _onnx_node("Unsqueeze", ["x_sr", "one_ax"], ["x3"]),
            _onnx_node("Conv", ["x3", "w1", "b1"], ["f1"],
                       _onnx_ints("strides", [8]) + _onnx_ints("kernel_shape", [16])),
            _onnx_node("Relu", ["f1"], ["f2"]),
            _onnx_node("Conv", ["f2", "w2", "b2"], ["f3"],
                       _onnx_ints("strides", [2]) + _onnx_ints("pads", [1, 1])),
            _onnx_node("Relu", ["f3"], ["f4"]),
            _onnx_node("ReduceMean", ["f4"], ["feat"],
                       _onnx_ints("axes", [-1]) + _onnx_int("keepdims", 0)),
            _onnx_node("Unsqueeze", ["feat", "zero_ax"], ["seq"]),
            _onnx_node("Gather", ["state", "i0"], ["h0s"], _onnx_int("axis", 0)),
            _onnx_node("Gather", ["state", "i1"], ["c0s"], _onnx_int("axis", 0)),
            _onnx_node("Unsqueeze", ["h0s", "zero_ax"], ["h0"]),
            _onnx_node("Unsqueeze", ["c0s", "zero_ax"], ["c0"]),
            _onnx_node("LSTM", ["seq", "W", "R", "B", "", "h0", "c0"], ["y", "hn", "cn"],
                       _onnx_int("hidden_size", hidden)),
            _onnx_node("Squeeze", ["y", "sq_ax"], ["y2"]),
            _onnx_node("Gemm", ["y2", "hw", "hb"], ["logit"], _onnx_int("transB", 1)),
            _onnx_node("Sigmoid", ["logit"], ["output"]),
            _onnx_node("Concat", ["hn", "cn"], ["stateN"], _onnx_int("axis", 0)),
        ],
        inits=[
            _onnx_tensor("sr16", np.asarray(16000, np.int64)),
            _onnx_tensor("one_ax", np.asarray([1], np.int64)),
            _onnx_tensor("zero_ax", np.asarray([0], np.int64)),
            _onnx_tensor("sq_ax", np.asarray([0, 1], np.int64)),
            _onnx_tensor("i0", np.asarray(0, np.int64)),
            _onnx_tensor("i1", np.asarray(1, np.int64)),
            _onnx_tensor("w1", normal(64, 1, 16, scale=0.25)),
            _onnx_tensor("b1", normal(64, scale=0.1)),
            _onnx_tensor("w2", normal(64, 64, 3, scale=0.07)),
            _onnx_tensor("b2", normal(64, scale=0.1)),
            _onnx_tensor("W", normal(1, 4 * hidden, 64, scale=0.12)),
            _onnx_tensor("R", normal(1, 4 * hidden, hidden, scale=0.09)),
            _onnx_tensor("B", normal(1, 8 * hidden, scale=0.1)),
            _onnx_tensor("hw", normal(1, hidden, scale=0.09)),
            _onnx_tensor("hb", normal(1, scale=0.1)),
        ],
        inputs=[("input", (None, 576)), ("state", (2, None, hidden)), ("sr", ())],
        outputs=["output", "stateN"],
    )
    path.write_bytes(_pb(7, 2, g))
    return str(path)


def scorer_ticks(torch, scorer, frames, states, load=None) -> float:
    """Median host ms of 20 device calls of the batched scorer over
    ``frames`` (copies in and out included); with ``load``, each call is
    made right after ``load()`` has enqueued work on the default stream."""
    times = []
    for i in range(21):
        if load is not None:
            load()
        t0 = time.perf_counter()
        scorer._score_device(frames, states)
        dt = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if i:
            times.append(dt)
    return float(np.median(times))


def vad_server_run(torch, vad_device: str) -> dict:
    """The port's gRPC server in-process (the bench's narrowed YAML, batch
    bucket 16 only, so every group pads to 16 rows and a row's decode does
    not depend on its neighbours; ``vad.device`` as given; drafting off),
    ``VAD_SESSIONS`` paced sessions of the load tool's audio (a mid-stream
    silence gap that trips the VAD) with partials on and a final at each
    VAD endpoint. Returns each session's finals (text, start, end), the
    latencies and the scorer's counters."""
    import tempfile

    import grpc
    import yaml

    from stt_tpu_torch import bench as B
    from stt_tpu_torch.gen import stt_pb2, stt_pb2_grpc
    from stt_tpu_torch.server import main as S
    from stt_tpu_torch.server.runtime.runtime import ApplicationRuntime
    from stt_tpu_torch.server.transport.grpc_servicer import STTGrpcServicer

    with tempfile.TemporaryDirectory(prefix="smoke_vad_") as tmp:
        server_yaml, model_yaml = B.e2e_configs(Path(tmp))
        cfg = yaml.safe_load(server_yaml.read_text())
        cfg["tpu"]["batch_buckets"] = [16]
        cfg.setdefault("vad", {})["device"] = vad_device
        server_yaml.write_text(yaml.safe_dump(cfg))
        config = S.configure_from_args(S.parse_args([
            "--config", str(server_yaml), "--model-config", str(model_yaml),
            "--model", "small", "--compute-type", "bfloat16", "--language", "en",
            "--port", "0", "--ws-port", "0"]))
    t0 = time.monotonic()
    with Switches({"STT_DRAFT_PARTIALS": "off"}):
        server = S.build_grpc_server(config)
        runtime = ApplicationRuntime(config)
    attrs = {"partial": "true", "emit_final_on_vad": "true"}
    try:
        stt_pb2_grpc.add_STTBackendServicer_to_server(STTGrpcServicer(runtime), server)
        port = S.bind_grpc_port(server, config)
        server.start()
        boot = time.monotonic() - t0
        sessions = [None] * VAD_SESSIONS

        def run(i: int) -> None:
            sessions[i] = grpc_session(grpc, stt_pb2, stt_pb2_grpc, port, f"smoke-vad-{i}",
                                       load_tool_audio(5.0, seed=200 + i), attributes=attrs)

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(VAD_SESSIONS)]
        t1 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        wall = time.monotonic() - t1
        scorer = runtime._vad_scorer
        counters = ({"batches": scorer.batches, "fallbacks": scorer.fallbacks,
                     "metrics": {k: v for k, v in runtime.metrics.render().items()
                                 if k.startswith("vad_scorer")}}
                    if scorer is not None else None)
    finally:
        server.stop(5.0).wait()
        runtime.shutdown()
    if any(th.is_alive() for th in threads) or None in sessions:
        fail(f"vad ({vad_device}): a session did not finish")
    for i, s in enumerate(sessions):
        if s["error"] or not s["finals"]:
            fail(f"vad ({vad_device}) session {i}: {s['error'] or 'no final'}")
    return {"finals": [[(r.text, round(r.start_sec, 3), round(r.end_sec, 3))
                        for r in s["finals"]] for s in sessions],
            "first": [s["first_partial_s"] for s in sessions if s["first_partial_s"] is not None],
            "final": [s["final_s"] for s in sessions], "boot": boot, "wall": wall,
            "scorer": counters}


def vad_phase(torch, card: str) -> dict:
    """Phase 3j, item 10: the batched VAD scorer on the card (ms per tick
    at 64 sessions x 3 frames, idle and right behind decode-sized work on
    the default stream, on its own stream and, for comparison, on the
    default stream; probabilities within ``VAD_ATOL`` of the numpy path);
    a Silero-v5-shaped ONNX graph scoring a stream on the card within
    ``VAD_ATOL`` of the port's executor on the CPU (ms per 3-frame chunk);
    then the gRPC server with ``vad_device: device`` and again with host
    VAD, 16 paced sessions each: the scorer's batches above 0 and its
    fallbacks 0, every session's VAD finals (endpoint decisions and texts)
    equal, first-partial and final p95 of both."""
    import tempfile

    from stt_tpu_torch.ops import vad as V
    from stt_tpu_torch.ops.silero import SileroVad, SileroVadSession
    from stt_tpu_torch.server.component.vad_scorer import BatchedVadScorer

    rng = np.random.default_rng(7)
    frames = (0.1 * rng.standard_normal((64, 3, V.VAD_FRAME_SAMPLES))).astype(np.float32)
    states = [V.init_state(np) for _ in range(64)]
    scorer = BatchedVadScorer("cuda")
    scorer.prewarm()
    got = scorer._score_device(frames, states)
    err = max(float(np.abs(p - V.vad_step(np, f, s)[0]).max())
              for (p, _), f, s in zip(got, frames, states))
    if err > VAD_ATOL:
        fail(f"vad scorer: probabilities differ from the numpy path by {err:.3g}")
    x = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

    def load():
        for _ in range(40):
            x @ x    # ~44 TFLOP of bf16 products queued on the default stream

    own = scorer._stream
    ticks = {"idle": scorer_ticks(torch, scorer, frames, states),
             "loaded, own stream": scorer_ticks(torch, scorer, frames, states, load)}
    scorer._stream = None
    ticks["loaded, default stream"] = scorer_ticks(torch, scorer, frames, states, load)
    scorer._stream = own
    del x
    log(f"vad scorer (64 sessions x 3 frames, one device call a tick): probabilities within "
        f"{err:.3g} of the numpy path; ms per tick (host clock, copies in and out): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ticks.items()) + f" ({card})")

    with tempfile.TemporaryDirectory(prefix="smoke_silero_") as tmp:
        path = silero_v5_shaped(Path(tmp) / "silero_v5.onnx")
        stream = (0.2 * np.random.default_rng(8).standard_normal((30, 512))).astype(np.float32)
        probs = {}
        chunk_ms = []
        for device in ("cuda", "cpu"):
            vad = SileroVad.from_onnx(path, device=device)
            if vad.state_names != ["state"] or vad.context_samples != 64 or vad.sr_name != "sr":
                fail(f"silero: signature read as {vad.state_names} / {vad.context_samples} / "
                     f"{vad.sr_name}")
            session = SileroVadSession(vad)
            out = []
            for i in range(0, len(stream), 3):
                t0 = time.perf_counter()
                out.append(session.score(stream[i:i + 3]))
                if device == "cuda" and i:
                    chunk_ms.append((time.perf_counter() - t0) * 1e3)
            probs[device] = np.concatenate(out)
            if device == "cuda" and (session._states[0].device.type != "cuda"
                                     or tuple(session._states[0].shape) != (2, 1, 128)):
                fail(f"silero: the state is {tuple(session._states[0].shape)} on "
                     f"{session._states[0].device}, not (2, 1, 128) on the card")
    s_err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    if not np.isfinite(probs["cuda"]).all() or s_err > VAD_ATOL:
        fail(f"silero (v5-shaped, card vs CPU executor): max abs err {s_err:.3g}")
    log(f"silero (v5-shaped graph, input [1, 576], state [2, 1, 128], seeded weights): 30 "
        f"frames on the card within {s_err:.3g} of the CPU executor (probabilities "
        f"{probs['cuda'].min():.3f}-{probs['cuda'].max():.3f}); "
        f"{float(np.median(chunk_ms)):.3f} ms per 3-frame chunk on the card ({card})")

    runs = {name: vad_server_run(torch, name) for name in ("device", "auto")}
    dev, host = runs["device"], runs["auto"]
    sc = dev["scorer"]
    if sc is None or sc["batches"] <= 0 or sc["fallbacks"] != 0 \
            or sc["metrics"].get("vad_scorer_fallbacks") != 0:
        fail(f"vad e2e: the scorer's counters {sc}")
    if host["scorer"] is not None:
        fail("vad e2e: the host-VAD server built a scorer")
    differ = [i for i, (a, b) in enumerate(zip(dev["finals"], host["finals"])) if a != b]
    if differ:
        fail(f"vad e2e: sessions {differ} end differently with device and host VAD: "
             f"{dev['finals'][differ[0]]} vs {host['finals'][differ[0]]}")
    endpoints = [len(f) for f in dev["finals"]]

    def p95(values):
        return float(np.percentile(values, 95)) if values else float("nan")

    log(f"vad e2e ({VAD_SESSIONS} sessions x 5 s at 2x, partials on, a final at each VAD "
        f"endpoint): device VAD {sc['batches']} scorer batches, {sc['fallbacks']} fallbacks; "
        f"every session's finals (texts and times) equal with host VAD ({endpoints} finals a "
        f"session); first partial p95 {p95(dev['first']):.3f} s device / "
        f"{p95(host['first']):.3f} s host, final p95 {p95(dev['final']):.3f} s / "
        f"{p95(host['final']):.3f} s; boot {dev['boot']:.1f} / {host['boot']:.1f} s ({card})")
    return {"ticks": ticks, "silero_chunk_ms": float(np.median(chunk_ms)),
            "first_p95": (p95(dev["first"]), p95(host["first"])),
            "final_p95": (p95(dev["final"]), p95(host["final"]))}


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


def grpc_session(grpc, stt_pb2, stt_pb2_grpc, port: int, sid: str, pcm: bytes,
                 profile: int = 0, attributes=None) -> dict:
    """One streaming session as the load tool runs it: CreateSession with
    the session ``attributes`` (default: partials on), language en and the
    decode ``profile`` (0: the server's default), 100 ms chunks at 2x real
    time, then ``is_final``. Returns the client's latencies, the finals and
    the trailing metadata, or the error."""
    out = {"finals": [], "first_partial_s": None, "final_s": None, "error": None}
    step = 1600 * 2
    last_sent = [0.0]
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        stub = stt_pb2_grpc.STTBackendStub(channel)
        try:
            stub.CreateSession(stt_pb2.SessionRequest(
                session_id=sid, attributes=attributes or {"partial": "true"},
                language_code="en",
                decode_profile=profile), timeout=60)

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


def http_get(port: int, path: str):
    """(status, body) of a GET on the HTTP plane; an error status too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def wav_bytes(pcm: bytes) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(pcm)
    return buf.getvalue()


def rest_transcribe(port: int, pcm: bytes, profile: str = "realtime"):
    """(status, JSON payload) of one REST transcription of ``pcm`` with the
    ``profile`` (empty: none named, the plane's default ``accurate``) and
    language en."""
    import urllib.error
    import urllib.request

    named = f"decode_profile={profile}&" if profile else ""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions?{named}"
        f"language=en&response_format=verbose_json", data=wav_bytes(pcm), method="POST",
        headers={"content-type": "audio/wav"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def ws_session(port: int, sid: str, pcm: bytes) -> list:
    """One WebSocket session through the bridge: the start frame (language
    en, partials on), 100 ms binary frames, then ``end``; returns the
    frames received up to ``done``."""
    from websockets.sync.client import connect

    frames = []
    with connect(f"ws://127.0.0.1:{port}/ws/stream", open_timeout=30) as ws:
        ws.send(json.dumps({"type": "start", "session_id": sid, "sample_rate": 16000,
                            "language_code": "en", "attributes": {"partial": "true"}}))
        for i in range(0, len(pcm), 3200):
            ws.send(pcm[i:i + 3200])
            time.sleep(0.05)
        ws.send(json.dumps({"type": "end"}))
        while True:
            frames.append(json.loads(ws.recv(timeout=120)))
            if frames[-1]["type"] in ("done", "error"):
                return frames


def http_checks(torch, port: int, metrics: dict, shapes: int) -> None:
    """Phase 5's reads of the HTTP plane after the gRPC traffic: /metrics
    carries the engine's counters as the runtime holds them, /metrics.json
    the same values, and /system (with ``STT_ENABLE_TPU_METRICS=1``) names
    the card."""
    import os

    status, text = http_get(port, "/metrics")
    values = dict(line.split(" ", 1) for line in text.splitlines()
                  if line.startswith("stt_engine_"))
    want = {f"stt_{k}": float(metrics[k]) for k in
            ("engine_step_count", "engine_compile_count", "engine_batch_rows_total")}
    got = {k: float(values.get(k, "nan")) for k in want}
    if status != 200 or got != want or not got["stt_engine_step_count"] > 0 \
            or got["stt_engine_compile_count"] != shapes:
        fail(f"http: /metrics {status}, engine counters {got}, runtime {want}")
    status, body = http_get(port, "/metrics.json")
    if status != 200 or json.loads(body)["engine_compile_count"] != shapes:
        fail(f"http: /metrics.json {status} {body[:200]}")
    os.environ["STT_ENABLE_TPU_METRICS"] = "1"
    try:
        status, body = http_get(port, "/system")
    finally:
        del os.environ["STT_ENABLE_TPU_METRICS"]
    card = json.loads(body).get("tpu", {}) if status == 200 else {}
    devices = card.get("devices") or [{}]
    if card.get("platform") != "gpu" or devices[0].get("kind") != torch.cuda.get_device_name(0):
        fail(f"http: /system {status} card section {card}")
    log(f"http: /metrics engine counters {got}; /system card section: "
        f"{card['device_count']} device(s), {devices[0]['kind']}, "
        f"{devices[0]['bytes_in_use'] / 2**30:.3f} GiB allocated of "
        f"{devices[0]['bytes_limit'] / 2**30:.1f} GiB")


def accurate_checks(grpc, stt_pb2, stt_pb2_grpc, port: int, http_port: int, card: str) -> dict:
    """Phase 5's ``accurate`` traffic (beam 5) after the realtime traffic:
    one gRPC session with ``DECODE_PROFILE_ACCURATE``, one REST
    transcription naming no profile, one ``batch_file`` client run in a
    process of its own (its default profile); each timed."""
    out = {}
    t0 = time.monotonic()
    session = grpc_session(grpc, stt_pb2, stt_pb2_grpc, port, "smoke-accurate",
                           load_tool_audio(5.0, seed=102),
                           profile=stt_pb2.DECODE_PROFILE_ACCURATE)
    out["grpc_s"] = time.monotonic() - t0
    if session["error"] or not session["finals"] or not all(
            r.text.strip() and r.language_code == "en" for r in session["finals"]):
        fail(f"accurate grpc: error {session['error']}, finals "
             f"{[r.text[:40] for r in session['finals']]}")
    log(f"accurate grpc: one session (5 s at 2x, partials on) in {out['grpc_s']:.2f} s, "
        f"final {session['final_s']:.3f} s after the last chunk, "
        f"{int(session['trailing']['stt-decode-count'])} decodes, inference "
        f"{float(session['trailing']['stt-decode-inference-sec']):.4f} s, final "
        f"{session['finals'][-1].text[:60]!r} ({card})")
    t0 = time.monotonic()
    status, payload = rest_transcribe(http_port, load_tool_audio(5.0, seed=103), profile="")
    out["rest_s"] = time.monotonic() - t0
    if status != 200 or not payload.get("text", "").strip():
        fail(f"accurate rest: {status} {str(payload)[:300]}")
    log(f"accurate rest: POST /v1/audio/transcriptions (5 s, no profile: accurate) 200 in "
        f"{out['rest_s']:.3f} s, text {payload['text'][:60]!r} ({card})")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "stt_tpu_torch.client.batch_file", "--target",
         f"127.0.0.1:{port}", "--language", "en", "--no-metrics"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    out["batch_file_s"] = time.monotonic() - t0
    lines = proc.stdout.splitlines()
    texts = [lines[i + 2].split(" : ", 1)[1] for i, line in enumerate(lines)
             if line == "[FINAL]" and lines[i + 2].lstrip().startswith("text")]
    if proc.returncode != 0 or not texts or not all(t.strip() for t in texts):
        fail(f"batch_file: exit {proc.returncode}, finals {texts}: "
             f"{(proc.stdout + proc.stderr)[-1500:]}")
    log(f"accurate batch_file: python3 -m stt_tpu_torch.client.batch_file (the bundled clip, "
        f"its default profile accurate) exit 0 in {out['batch_file_s']:.2f} s (process "
        f"included), {len(texts)} final(s), {texts[-1][:60]!r} ({card})")
    return out


def grpc_phase(torch, card: str) -> int:
    """Phase 5: the port's server in-process, gRPC, HTTP plane and (when
    ``websockets`` imports) WebSocket bridge, 8 concurrent streaming gRPC
    sessions, the HTTP plane's reads, one REST transcription and one WS
    session, checked as the docstring says. Returns the log-mel launches
    of the gRPC traffic."""
    import socket
    import tempfile

    import grpc
    import yaml

    from stt_tpu_torch import bench as B
    from stt_tpu_torch.config.loader import DEFAULT_MODEL_CONFIG_PATH
    from stt_tpu_torch.gen import stt_pb2, stt_pb2_grpc
    from stt_tpu_torch.ops.kernels.mel import mel_logspec
    from stt_tpu_torch.server import main as S
    from stt_tpu_torch.server.runtime.runtime import ApplicationRuntime
    from stt_tpu_torch.server.transport.grpc_servicer import STTGrpcServicer
    from stt_tpu_torch.server.transport.http_server import start_http_server

    with tempfile.TemporaryDirectory(prefix="smoke_grpc_") as tmp:
        server_yaml, model_yaml = B.e2e_configs(Path(tmp))
        # the bench's narrowing drops the beam-5 accurate profile, which this
        # phase serves: put the shipped profiles back, so the boot prewarms
        # beams 1 and 5
        model_cfg = yaml.safe_load(model_yaml.read_text())
        model_cfg["model"]["decode_profiles"] = yaml.safe_load(
            DEFAULT_MODEL_CONFIG_PATH.read_text())["model"]["decode_profiles"]
        model_yaml.write_text(yaml.safe_dump(model_cfg))
        config = S.configure_from_args(S.parse_args([
            "--config", str(server_yaml), "--model-config", str(model_yaml),
            "--model", "small", "--compute-type", "bfloat16", "--language", "en",
            "--port", "0", "--ws-port", "0"]))
    t0 = time.monotonic()
    server = S.build_grpc_server(config)
    runtime = ApplicationRuntime(config)
    # the planes as serve() starts them: HTTP (and WS) once the runtime is
    # built, so the model is loaded and every shape prewarmed; /health says
    # ready only once the gRPC server has started
    server_state = {"grpc_running": False}
    http = start_http_server(runtime, server_state, "127.0.0.1", 0)
    ws = ws_port = None
    try:
        import websockets  # noqa: F401
    except ImportError:
        log("ws: websockets does not import on this host; the WebSocket bridge was not "
            "started (serve() logs the same and serves gRPC + HTTP)")
    else:
        from stt_tpu_torch.server.transport.ws_server import start_ws_server

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ws_port = sock.getsockname()[1]
        ws = start_ws_server(runtime, "127.0.0.1", ws_port)
    try:
        stt_pb2_grpc.add_STTBackendServicer_to_server(STTGrpcServicer(runtime), server)
        port = S.bind_grpc_port(server, config)
        engine = runtime.model_registry._pools["default"].engines[0]
        shapes = engine.graph_captures
        early, _ = http_get(http.port, "/health")
        server.start()
        server_state["grpc_running"] = True
        boot = time.monotonic() - t0
        ready, health = http_get(http.port, "/health")
        if early != 500 or ready != 200 or json.loads(health)["status"] != "ok":
            fail(f"http: /health answered {early} before the gRPC server started and "
                 f"{ready} {health[:200]} after")
        if not shapes:
            fail("http: /health answered 200 with no shape prewarmed")
        log(f"http: /health {early} before the gRPC server started (model loaded, "
            f"{shapes} shapes prewarmed), {ready} after; HTTP plane on port {http.port}")
        drafted_shapes = sum(1 for k in engine.graphs._entries if k.drafted)
        if engine._draft_mode != "adaptive" or not drafted_shapes:
            fail(f"grpc: the shipped server runs draft mode {engine._draft_mode!r} with "
                 f"{drafted_shapes} drafted shapes prewarmed; adaptive with every bucket's "
                 f"drafted entries expected")
        log(f"grpc: server booted in {boot:.2f} s on port {port} (device {config.device} -> "
            f"{engine.device}, backend {config.model_backend}, whisper-{engine.model_size} "
            f"{engine._dtype}, policy {engine.policy}, draft mode {engine._draft_mode}); "
            f"{shapes} shapes prewarmed, {drafted_shapes} of them drafted "
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
        http_checks(torch, http.port, after, shapes)
        _, text = http_get(http.port, "/metrics")
        log(f"grpc: /metrics draft counters after the sessions: "
            + ", ".join(line for line in text.splitlines() if line.startswith("stt_draft"))
            + f"; engine draft stats {engine.draft_stats}")
        mel_logspec.launches = 0
        t2 = time.monotonic()
        status, payload = rest_transcribe(http.port, load_tool_audio(5.0, seed=100))
        rest_s, rest_launches = time.monotonic() - t2, mel_logspec.launches
        if status != 200 or not payload.get("text", "").strip() \
                or not payload.get("segments"):
            fail(f"rest: {status} {str(payload)[:300]}")
        if rest_launches <= 0:
            fail("rest: the transcription never launched the log-mel kernel")
        log(f"rest: POST /v1/audio/transcriptions (5 s, realtime, verbose_json) 200 in "
            f"{rest_s:.3f} s, {len(payload['segments'])} segment(s), text "
            f"{payload['text'][:60]!r}, {rest_launches} log-mel launch(es)")
        if ws is not None:
            t3 = time.monotonic()
            frames = ws_session(ws_port, "smoke-ws", load_tool_audio(5.0, seed=101))
            finals = [f for f in frames if f["type"] == "result" and f.get("is_final")]
            if frames[-1]["type"] != "done" or not finals or not finals[-1]["text"].strip():
                fail(f"ws: frames {[f['type'] for f in frames]}, last {str(frames[-1])[:300]}")
            log(f"ws: one session through the bridge in {time.monotonic() - t3:.2f} s, "
                f"{len(frames)} frames ({', '.join(sorted({f['type'] for f in frames}))}), "
                f"final {finals[-1]['text'][:60]!r}")
        accurate_checks(grpc, stt_pb2, stt_pb2_grpc, port, http.port, card)
        if engine.graph_captures != shapes:
            fail(f"accurate: {engine.graph_captures - shapes} decode graphs captured while "
                 f"serving")
    finally:
        server_state["grpc_running"] = False
        server.stop(5.0).wait()
        http.stop(timeout=6.0)
        if ws is not None:
            ws.stop(timeout=6.0)
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


def reference_f32_phase(torch, E, W, dev, clips, flash: str) -> int:
    """Phase 4a: the ``test`` model in float32 on the card against the CPU,
    on ``clips`` of (seconds, language), flash attention ``flash``: encoder
    output and teacher-forced decoder logits within ``REF_ATOL``. With flash
    on at the 30 s bucket the card runs the kernel's float32 body once per
    encoder layer per encode (two encodes here) and the CPU never launches
    it; returns the card's flash launches. TF32 stays off in cuBLAS and cuDNN (set in main), so the card's
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
        if name == "cuda":
            card_launches = ran
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
    return card_launches


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


# -- phase 3k: training through the flash backward kernels; the mesh -------------

TRAIN_ROWS, TRAIN_TOKENS, TRAIN_STEPS = 4, 128, 5
TRAIN_BF16_STEPS = 3
TRAIN_BF16_LOSS_REL = 1e-2   # bf16 flash on vs off, step 1's loss
BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest |gradient|
TRAIN_GRAD_REL = 1e-4        # flash on vs off, and a mesh vs one process, float32
TRAIN_LOSS_REL = 1e-5        # a mesh's loss vs one process's, float32


def sass_hgmma(name: str = "flash_attention_bwd") -> dict:
    """Counts of ``HGMMA`` (wgmma) instructions in each kernel of the built
    object of ``<name>.cu``, from ``cuobjdump -sass`` beside ``nvcc``;
    empty when the toolkit has no ``cuobjdump``."""
    from stt_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.is_file():
        return {}
    out = subprocess.run([str(tool), "-sass", str(build._object_path(name, nvcc))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed for {name}: {out.stderr.strip()[:400]}")
    counts, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    return counts


def settled_ms(torch, fn, retakes: dict, tag: str, tries: int = 3) -> float:
    """``cuda_ms_cold`` of a ctypes-launched kernel, taken again (up to
    ``tries`` readings) while a host enqueue inside the timed loop outlasted
    the device's spin: the wrapper drops the GIL for the launch and takes it
    back before the end event is enqueued, so another Python thread or a
    collection can hold the end event back, and the reading would count that
    host time. ``retakes[tag]`` records the discarded readings."""
    for attempt in range(tries):
        report = {}
        ms = cuda_ms_cold(torch, fn, report=report)
        if report["in_loop_ms"] <= report["spin_ms"]:
            break
        if attempt + 1 < tries:
            retakes.setdefault(tag, []).append(
                f"{ms:.4f} ms (host {report['in_loop_ms']:.2f} ms > spin {report['spin_ms']:.2f})")
    return ms


def bwd_kernels_phase(torch) -> dict:
    """3k (a): the forward's log-sum-exp and the dK/dV and dQ kernels at 4 x
    12 x 1500 x 64, float32 and bf16, against the plain versions (and the
    library's backward, an independent check); a second call of each
    kernel bit-identical to the first; the HGMMA count of each bf16 body's
    SASS; cold times of each kernel (taken again after a host stall, as
    :func:`settled_ms` says), its plain version and the library's backward
    (autograd through SDPA, backward only; timed three times, its spread
    printed), each kernel's share of its bound and its ratio to the library
    call, and the served forward with and without the log-sum-exp.
    Returns each type's numbers, keyed by type name, then kernel."""
    import torch.nn.functional as F
    from stt_tpu_torch.ops.kernels import flash_attention as FA

    dev = torch.device("cuda", 0)
    b, h, t, dh = 4, 12, 1500, 64
    n = b * h * t
    hgmma = sass_hgmma()
    wgmma = {name: c for name, c in hgmma.items() if "wgmma_kernel" in name}
    if hgmma and (len(wgmma) != 6 or min(wgmma.values()) == 0):
        fail(f"3k (a): the bf16 backward bodies' SASS holds HGMMA counts {wgmma}")
    log("3k (a) HGMMA instructions in each bf16 backward body's SASS (cuobjdump -sass): "
        + (json.dumps(wgmma) if hgmma else "not counted (no cuobjdump beside nvcc)"))
    out = {}
    for dtype, peak in ((torch.float32, H100_F32_FLOPS), (torch.bfloat16, H100_BF16_FLOPS)):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator(device=dev).manual_seed(1717)
        scale = dh ** -0.25
        q, k, v = ((torch.randn((b, h, t, dh), generator=gen, device=dev) * sc).to(dtype)
                   for sc in (scale, scale, 1.0))
        do = torch.randn((b, h, t, dh), generator=gen, device=dev).to(dtype)
        o, lse = FA.flash_attention_with_lse(q, k, v)
        ref_o, ref_lse = FA.flash_attention_plain(q, k, v, with_lse=True)
        lse_err = (lse - ref_lse).abs().max().item()
        di = FA.attention_di(o, do)
        dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, di)
        dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, di)
        dk2, dv2 = FA.flash_attention_bwd_dkv(q, k, v, do, lse, di)
        dq2 = FA.flash_attention_bwd_dq(q, k, v, do, lse, di)
        pk, pv = FA.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di)
        pq = FA.flash_attention_bwd_dq_plain(q, k, v, do, lse, di)
        qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qq, kk, vv, scale=1.0)
        lq, lk, lv = torch.autograd.grad(lib_o, (qq, kk, vv), do, retain_graph=True)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)):
            fail(f"flash backward {name}: a second call of the kernels is not bit-identical")
        del dk2, dv2, dq2
        errs, lib_errs, abs_errs = {}, {}, {}
        for g, p, lg, tag in ((dq, pq, lq, "dq"), (dk, pk, lk, "dk"), (dv, pv, lv, "dv")):
            if g.shape != q.shape or g.dtype != dtype or not torch.isfinite(g).all():
                fail(f"flash backward {name} {tag}: shape {tuple(g.shape)}, {g.dtype} or "
                     f"non-finite values")
            scale_g = p.float().abs().max().item()
            abs_errs[tag] = (g.float() - p.float()).abs().max().item()
            errs[tag] = abs_errs[tag] / scale_g
            lib_errs[tag] = (g.float() - lg.float()).abs().max().item() / scale_g
        if lse_err > 1e-3 or max(errs.values()) > BWD_REL[name]:
            fail(f"flash backward {name}: lse err {lse_err:.3g}, gradients "
                 f"{errs} of the largest |gradient| (bar {BWD_REL[name]})")
        library = [cuda_ms_cold(torch, lambda: torch.autograd.grad(
            lib_o, (qq, kk, vv), do, retain_graph=True)) for _ in range(3)]
        retakes = {}
        times = {
            "dkv": settled_ms(torch, lambda: FA.flash_attention_bwd_dkv(q, k, v, do, lse, di),
                              retakes, "dK/dV"),
            "dq": settled_ms(torch, lambda: FA.flash_attention_bwd_dq(q, k, v, do, lse, di),
                             retakes, "dQ"),
            "dkv_plain": cuda_ms_cold(
                torch, lambda: FA.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di), iters=5),
            "dq_plain": cuda_ms_cold(
                torch, lambda: FA.flash_attention_bwd_dq_plain(q, k, v, do, lse, di), iters=5),
            "fwd": cuda_ms_cold(torch, lambda: FA.flash_attention(q, k, v)),
            "fwd_lse": cuda_ms_cold(torch, lambda: FA.flash_attention_with_lse(q, k, v)),
        }
        lib_ms = min(library)
        es = q.element_size()
        bounds = {"dkv": bound(6 * n * dh * es + 8 * n, 8.0 * b * h * t * t * dh, peak),
                  "dq": bound(5 * n * dh * es + 8 * n, 6.0 * b * h * t * t * dh, peak)}

        def kernel_text(kern: str, label: str) -> str:
            ms, (bms, by) = times[kern], bounds[kern]
            return (f"{label} {ms:.4f} ms (plain {times[kern + '_plain']:.4f}, bound {bms:.4g} "
                    f"ms {by}, {bms / ms:.1%} of it; {ms / lib_ms:.2f}x the library call)")

        pair = times["dkv"] + times["dq"]
        log(f"3k (a) flash backward B{b} H{h} T{t} Dh{dh} {name}: lse max abs err "
            f"{lse_err:.3g}; against the plain backward, of the largest |gradient|: "
            + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
            + " (library's backward: " + ", ".join(f"{k_} {e:.3g}" for k_, e in lib_errs.items())
            + f"); a second call bit-identical; {kernel_text('dkv', 'dK/dV')}, "
            f"{kernel_text('dq', 'dQ')}; the pair {pair:.4f} ms, {pair / lib_ms:.2f}x the library "
            f"backward (SDPA, dQ dK dV) {lib_ms:.4f} ms (three timings {min(library):.4f}-"
            f"{max(library):.4f}); served forward {times['fwd']:.4f} ms, with the log-sum-exp "
            f"{times['fwd_lse']:.4f} ms; kernel readings taken again after a host stall: "
            f"{retakes or 'none'}")
        out[name] = {}
        for kern in ("dkv", "dq"):
            out[name][kern] = dict(
                max_abs_err=max(abs_errs[x] for x in (("dk", "dv") if kern == "dkv"
                                                      else ("dq",))),
                ms=times[kern], plain_ms=times[f"{kern}_plain"],
                bound_ms=bounds[kern][0], bound_by=bounds[kern][1], library_ms=lib_ms)
        del q, k, v, do, o, lse, ref_o, ref_lse, dq, dk, dv, pq, pk, pv, lib_o, lq, lk, lv
        torch.cuda.empty_cache()
    return out


def train_batch(W, T):
    """3k's batch: 4 rows of a 30 s mel (80 x 3000), 128 random token ids
    under 1000 a row, a mask of ones (``__graft_entry__.py:84-91``)."""
    rng = np.random.default_rng(17)
    return T.TrainBatch(rng.normal(0, 1, (TRAIN_ROWS, 80, 3000)).astype(np.float32),
                        rng.integers(0, 1000, (TRAIN_ROWS, TRAIN_TOKENS)).astype(np.int64),
                        np.ones((TRAIN_ROWS, TRAIN_TOKENS), np.float32))


def grad_errors(got: dict, ref: dict) -> float:
    """The largest, over the leaves, of max |got - ref| / max |ref|."""
    worst = 0.0
    for name, r in ref.items():
        g = got[name]
        if g.shape != r.shape:
            fail(f"gradient {name}: shape {tuple(g.shape)} against {tuple(r.shape)}")
        worst = max(worst, ((g.float() - r.float()).abs().max()
                            / r.float().abs().max().clamp_min(1e-30)).item())
    return worst


def train_phase(torch, W, workdir: str, size: str = "small", device: str = "cuda:0") -> dict:
    """3k (b) and (e): whisper-small float32 at (1, 1), flash on: 5 steps of
    the 30 s batch (losses finite, the 5th below the 1st), ms a step, peak
    memory, each kernel's launches a step; then the first step's loss and
    gradients with flash off (twice, the second timed; peak memory), which
    the flash step's must match; a checkpoint after step 2, then a fresh trainer
    restored from it whose step 3 is bitwise the run's. Returns the losses,
    the first step's gradients (on the host), the checkpoint's path, the
    launches, the ms a step and the peaks. ``size`` and ``device`` let the
    host rehearse it (the "test" model on the CPU)."""
    from stt_tpu_torch.ops.kernels import flash_attention as FA
    from stt_tpu_torch.parallel import trainer as T
    from stt_tpu_torch.parallel.checkpoint import restore_checkpoint, save_checkpoint
    from stt_tpu_torch.parallel.sharding import build_mesh

    config = W.get_config(size)
    dev = torch.device(device)
    params = W.init_params(config, seed=0)
    batch = train_batch(W, T)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = build_mesh((1, 1), [dev])
    kernels = (FA.flash_attention, FA.flash_attention_bwd_dkv, FA.flash_attention_bwd_dq)

    trainer = T.ShardedTrainer(config, mesh, flash_attention="auto")
    state = trainer.init_state(params)
    ckpt = str(Path(workdir) / "train-step2.pt")
    losses, ms, launches = [], [], [0, 0, 0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        for kern in kernels:
            kern.launches = 0
        sync()
        t0 = time.perf_counter()
        if step == 0:
            losses.append(trainer.value_and_grad(state, batch))
            grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
            state.optimizer.step()
            state.step += 1
        else:
            losses.append(trainer.train_step(state, batch))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = [kern.launches for kern in kernels]
        if dev.type == "cuda" and counts != [config.n_audio_layer] * 3:
            fail(f"3k (b) step {step + 1}: launches forward, dK/dV, dQ {counts}, want "
                 f"{config.n_audio_layer} each")
        launches = [a + c for a, c in zip(launches, counts)]
        if step == 1:
            save_checkpoint(ckpt, trainer, state)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"3k (b): losses {losses} not finite and falling")
    del state
    torch.cuda.empty_cache()

    plain = T.ShardedTrainer(config, mesh, flash_attention="off")
    state = plain.init_state(params)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    plain.value_and_grad(state, batch)  # warm-up; the second call is timed
    sync()
    t0 = time.perf_counter()
    plain_loss = plain.value_and_grad(state, batch)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    plain_grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()
    flash_err = grad_errors(grads, plain_grads)
    loss_err = abs(losses[0] - plain_loss) / abs(plain_loss)
    if flash_err > TRAIN_GRAD_REL or loss_err > TRAIN_LOSS_REL:
        fail(f"3k (b): flash on against off: loss {loss_err:.3g} (relative), gradients "
             f"{flash_err:.3g} of each leaf's largest |gradient| (bars {TRAIN_LOSS_REL}, "
             f"{TRAIN_GRAD_REL})")
    log(f"3k (b) trainer (1, 1), whisper-{size} float32, flash on, {TRAIN_ROWS} x 30 s, "
        f"{TRAIN_TOKENS} tokens: losses {[round(x, 6) for x in losses]}; ms a step "
        f"{[round(x, 1) for x in ms]}; peak memory {peak:.2f} GiB; launches a step forward, "
        f"dK/dV, dQ {[config.n_audio_layer] * 3}; step 1 against flash off (plain attention "
        f"on the card; its loss and gradients, a second call: {plain_ms:.1f} ms, peak "
        f"{plain_peak:.2f} GiB): loss {loss_err:.3g} relative, gradients {flash_err:.3g} of each leaf's "
        f"largest |gradient|")
    del plain_grads
    third = losses[2]

    # (e) a fresh trainer from the step-2 checkpoint: step 3 bitwise
    t0 = time.monotonic()
    again = T.ShardedTrainer(config, mesh, flash_attention="auto")
    restored = restore_checkpoint(ckpt, again)
    resumed = again.train_step(restored, batch)
    if restored.step != 3 or resumed != third:
        fail(f"3k (e): resumed step {restored.step}, loss {resumed!r} against the run's "
             f"{third!r}")
    log(f"3k (e) checkpoint after step 2 ({Path(ckpt).stat().st_size / 1e9:.2f} GB), restored "
        f"into a fresh trainer: step 3 loss {resumed!r}, bitwise the uninterrupted run's "
        f"({time.monotonic() - t0:.1f} s)")
    del restored, again
    torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "ckpt": ckpt, "launches": launches, "ms": ms,
            "peak_gib": peak, "plain_ms": plain_ms, "plain_peak_gib": plain_peak}


def train_bf16_phase(torch, W, size: str = "small", device: str = "cuda:0") -> dict:
    """3k (b), bf16: whisper-small with bf16 parameters at (1, 1), flash on
    (the bf16 bodies of the forward and both backward kernels): 3 steps of
    the 30 s batch, losses finite, each kernel launched 12 times a step
    (counts set to 0 before each step), ms a step and peak memory; step 1's
    loss within 1e-2 (relative) of the same step with flash off. Returns
    the losses, the ms a step, the peak and the launches of the 3 steps."""
    from stt_tpu_torch.ops.kernels import flash_attention as FA
    from stt_tpu_torch.parallel import trainer as T
    from stt_tpu_torch.parallel.sharding import build_mesh

    config = W.get_config(size)
    dev = torch.device(device)
    params = W.init_params(config, seed=0)
    batch = train_batch(W, T)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = build_mesh((1, 1), [dev])
    kernels = (FA.flash_attention, FA.flash_attention_bwd_dkv, FA.flash_attention_bwd_dq)
    trainer = T.ShardedTrainer(config, mesh, flash_attention="auto")
    state = trainer.init_state(params, torch.bfloat16)
    losses, ms, launches = [], [], [0, 0, 0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_BF16_STEPS):
        for kern in kernels:
            kern.launches = 0
        sync()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(state, batch))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = [kern.launches for kern in kernels]
        if dev.type == "cuda" and counts != [config.n_audio_layer] * 3:
            fail(f"3k (b) bf16 step {step + 1}: launches forward, dK/dV, dQ {counts}, want "
                 f"{config.n_audio_layer} each")
        launches = [a + c for a, c in zip(launches, counts)]
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    if not all(np.isfinite(losses)):
        fail(f"3k (b) bf16: losses {losses} not finite")
    del state
    torch.cuda.empty_cache()
    plain = T.ShardedTrainer(config, mesh, flash_attention="off")
    state = plain.init_state(params, torch.bfloat16)
    plain_loss = plain.value_and_grad(state, batch)
    del state
    torch.cuda.empty_cache()
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    if not rel <= TRAIN_BF16_LOSS_REL:
        fail(f"3k (b) bf16: step 1's loss {losses[0]!r} against {plain_loss!r} with flash off "
             f"({rel:.3g} relative, bar {TRAIN_BF16_LOSS_REL})")
    log(f"3k (b) trainer (1, 1), whisper-{size} bf16, flash on, {TRAIN_ROWS} x 30 s, "
        f"{TRAIN_TOKENS} tokens: losses {[round(x, 6) for x in losses]}; ms a step "
        f"{[round(x, 1) for x in ms]}; peak memory {peak:.2f} GiB; launches a step forward, "
        f"dK/dV, dQ {[config.n_audio_layer] * 3}; step 1 against flash off: loss "
        f"{plain_loss:.6f}, {rel:.3g} relative")
    return {"losses": losses, "ms": ms, "peak_gib": peak, "launches": launches,
            "loss_rel": rel}


def mesh_train_phase(torch, W, run: dict, workdir: str, size: str = "small",
                     device: str = "cuda:0") -> None:
    """3k (c) and the rest of (e): two gloo ranks on cuda:0 at (2, 1) and (1,
    2), the 30 s batch with flash on: each mesh's first loss and full
    gradients against (b)'s first step, its second loss against (b)'s
    second; then the step-2 checkpoint restored at (1, 2), its step 3
    against (b)'s."""
    from stt_tpu_torch.parallel import dryrun
    from stt_tpu_torch.parallel import trainer as T

    batch = tuple(train_batch(W, T))
    devices = [device, device]
    for shape in ((2, 1), (1, 2)):
        path = str(Path(workdir) / f"grads-{shape[0]}x{shape[1]}.pt")
        t0 = time.monotonic()
        results = dryrun.spawn(dryrun.grads_rank, 2,
                               (shape, devices, size, 0, batch, "auto", 2, path),
                               workdir=workdir, timeout=300.0)
        seconds = time.monotonic() - t0
        losses, _, step_s = results[0]
        grads = torch.load(path, weights_only=True)
        err = grad_errors(grads, run["grads"])
        loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses, run["losses"])]
        if max(loss_errs) > TRAIN_LOSS_REL or err > TRAIN_GRAD_REL:
            fail(f"3k (c) mesh {shape}: losses {losses} against {run['losses'][:2]}, gradients "
                 f"{err:.3g} of each leaf's largest |gradient|")
        log(f"3k (c) mesh {shape}, 2 gloo ranks on {device}: losses {losses} (relative to "
            f"(1, 1): {[f'{e:.3g}' for e in loss_errs]}), gradients {err:.3g} of each leaf's "
            f"largest |gradient|; seconds a step (loss and gradients, rank 0) "
            f"{[round(x, 3) for x in step_s]}, {seconds:.1f} s with start-up")
        Path(path).unlink()
    t0 = time.monotonic()
    results = dryrun.spawn(dryrun.restore_rank, 2,
                           ((1, 2), devices, size, run["ckpt"], batch, "auto"),
                           workdir=workdir, timeout=300.0)
    step, loss = results[0]
    rel = abs(loss - run["losses"][2]) / abs(run["losses"][2])
    if step != 2 or rel > TRAIN_LOSS_REL:
        fail(f"3k (e): restored at (1, 2) from step {step}, step 3 loss {loss} against "
             f"{run['losses'][2]}")
    log(f"3k (e) the step-2 checkpoint restored at (1, 2): step 3 loss {loss} ({rel:.3g} from "
        f"(1, 1)'s; {time.monotonic() - t0:.1f} s)")


def mesh_serve_phase(torch, E, W) -> dict:
    """3k (d): the engine at (1, 2), both slots on cuda:0: float32 at 4 x
    10 s with the single engine's tokens; bf16 at 64 x 10 s, the captured
    greedy step beside the single engine's and the token agreement; the
    "test" model's serving proofs and the registry with ``mesh_shape``
    serving two sessions' partials and finals (the dry run's)."""
    from stt_tpu_torch import bench as B
    from stt_tpu_torch.parallel import dryrun

    mesh = dict(mesh_shape=(1, 2), mesh_devices=["cuda:0", "cuda:0"])
    out = {}
    tokens = {}
    for tag, kw in (("single", {}), ("mesh", mesh)):
        eng = small_engine(E, compute_type="float32", batch_buckets=(4,), **kw)
        try:
            outs = eng._harvest(eng._device_phase(group_tasks(E, 10.0, 4, 60)))
            tokens[tag] = [o._tokens.tolist() for o in outs]
        finally:
            release(eng)
    if tokens["mesh"] != tokens["single"]:
        fail("3k (d): the float32 (1, 2) mesh's tokens differ from the single engine's")
    log("3k (d) float32, 4 x 10 s: the (1, 2) mesh's tokens equal the single engine's")
    for tag, kw in (("single", {}), ("mesh", mesh)):
        eng = small_engine(E, **kw)
        try:
            eng.prewarm([10.0], [64])
            captures = eng.graph_captures
            outs = eng._harvest(eng._device_phase(group_tasks(E, 10.0, 64, 90)))
            if eng.graph_captures != captures:
                fail(f"3k (d) {tag}: a graph was captured while serving")
            tokens[tag] = np.stack([o._tokens for o in outs])
            out[f"{tag}_step_ms"] = B.decode_step_ms(eng, 10.0, 64, captured=True)
        finally:
            release(eng)
    agree = float((tokens["mesh"] == tokens["single"]).mean())
    log(f"3k (d) bf16, 64 x 10 s: captured greedy step {out['mesh_step_ms']:.4f} ms on the "
        f"(1, 2) mesh against {out['single_step_ms']:.4f} ms on one device "
        f"({out['mesh_step_ms'] / out['single_step_ms']:.2f}x); token agreement {agree:.3f}")
    out["agreement"] = agree
    dryrun.serving_proofs((1, 2), ["cuda:0", "cuda:0"])
    dryrun.registry_proof((1, 2), ["cuda:0", "cuda:0"])
    return out


def phase_3k(torch, E, W) -> dict:
    """Phase 3k: (a) the kernels, (b) + (e) the (1, 1) trainer and its
    checkpoint, then (b)'s bf16 run, (c) + (e) two ranks, (d) mesh serving.
    Returns the kernels' numbers by type with the launches of (b)'s float32
    5 steps and bf16 3 steps, and the forward's launches in each."""
    import tempfile

    t0 = time.monotonic()
    kernels = bwd_kernels_phase(torch)
    with tempfile.TemporaryDirectory(dir=ROOT) as workdir:
        run = train_phase(torch, W, workdir)
        run_bf16 = train_bf16_phase(torch, W)
        mesh_train_phase(torch, W, run, workdir)
    serve = mesh_serve_phase(torch, E, W)
    for name, launches in (("float32", run["launches"]), ("bfloat16", run_bf16["launches"])):
        kernels[name]["dkv"]["launches"] = launches[1]
        kernels[name]["dq"]["launches"] = launches[2]
        kernels[name]["forward_launches"] = launches[0]
    log(f"phase 3k: {time.monotonic() - t0:.1f} s")
    log("phase 3k: " + json.dumps({"train_ms": run["ms"], "losses": run["losses"],
                                   "peak_gib": run["peak_gib"], "plain_ms": run["plain_ms"],
                                   "plain_peak_gib": run["plain_peak_gib"],
                                   "bf16": run_bf16, "serve": serve}))
    return kernels


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
    cross = cross_mm_phase(torch, W, dev)
    flash_err, flash_headline, flash32_headline = flash_phase(torch, dev)

    # -- 2b. narrow operands, float32 accumulation -------------------------------
    narrow_phase(torch, W, dev)

    # -- 3a. served requests, default path (int8 cross K/V, einsum attention) ---
    default = serve_default_phase(torch, E, W, "mulaw")
    default_int16 = serve_default_phase(torch, E, W, "int16")
    launches = default["mel_logspec"]

    # -- 3b. served requests, 30 s path (fp8 cross K/V, both attention kernels) -
    counts_30s = serve_30s_phase(torch, E, W)

    # -- 3c. decode graphs in float32; 3d. one round of the port's bench --------
    graphs_f32_phase(torch, E, W)
    bench_phase()

    # -- 3f. drafted partials (the shipped STT_DRAFT_PARTIALS=adaptive) --------
    drafted_launches = drafted_phase(torch, E, W)

    # -- 3e. beam search at beam 5 (the accurate profile), both paths ----------
    beam_int8, _ = serve_beam_phase(
        torch, E, W, "int8 cross K/V, einsum",
        dict(cross_kv_dtype="int8", xattn_kernel="off", flash_attention="off"),
        [6.0, 7.5, 9.0, 10.0], (4, 64))
    beam_30s, _ = serve_beam_phase(
        torch, E, W, "fp8 cross K/V, both kernels",
        dict(cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto"),
        [12.0, 20.0, 25.0, 30.0], (4,))

    # -- 3g. the decode routes: prompts, prefix, penalties, ladder, timestamps, clips
    routes = route_phase(torch, E, W)
    route_reference_f32(torch, E, W)
    timestamp_ties_bf16(torch, E, W)

    # -- 3h. long finals (the seek loop), word timestamps, checkpoint loading ---
    t_3h = time.monotonic()
    long_words = long_words_phase(torch, E, W)
    log(f"phase 3h: {time.monotonic() - t_3h:.1f} s")

    # -- 3i. decoder policies, use_pallas false, a bound off the chunk; 3j. VAD --
    t_3i = time.monotonic()
    with SeededParams(W):
        policies = policy_phase(torch, E, W, M, card)
        bound = bound_phase(torch, E, W)
    log(f"phase 3i: {time.monotonic() - t_3i:.1f} s")
    t_3j = time.monotonic()
    with SeededParams(W):
        vad = vad_phase(torch, card)
    log(f"phase 3j: {time.monotonic() - t_3j:.1f} s")
    log("phases 3i-3j: " + json.dumps({"policies": policies["summary"], "bound": bound,
                                        "vad": vad}))

    # -- 3k. training through the flash backward kernels; the (data, model) mesh -
    train = phase_3k(torch, E, W)

    # -- 5. the gRPC streaming path (before 4: the server's engine is shut down first)
    grpc_phase(torch, card)

    # -- 4. reference on small inputs -------------------------------------------
    reference_f32_phase(torch, E, W, dev, [(1.5, "en"), (0.7, None)], flash="off")
    f32_launches = reference_f32_phase(torch, E, W, dev, [(30.0, "en"), (24.0, None)],
                                       flash="auto")
    reference_30s_phase(torch, E, W, dev)

    # -- 6. result -------------------------------------------------------------
    kernels = [{
        "name": "mel_logspec",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/mel.cu",
        "replaces": "stt_tpu/ops/pallas/mel.py:84",
        "launches": (launches + beam_int8["mel_logspec"] + beam_30s["mel_logspec"]
                     + drafted_launches + routes["mel_logspec"] + long_words["mel_logspec"]
                     + policies["mel_logspec"] + bound["mel_logspec"]),
        "max_abs_err": max(mel_err.values()),
        **headline,
    }, {
        "name": "xattn_decode",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/xattn_decode.cu",
        "replaces": "stt_tpu/ops/pallas/xattn_decode.py:186",
        "launches": (counts_30s["xattn_decode"] + beam_30s["xattn_decode"]
                     + routes["xattn_decode"] + long_words["xattn_decode"]),
        "max_abs_err": xattn_err,
        **xattn_headline,
    }, *({
        "name": name,
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/cross_mm.cu",
        "replaces": "stt_tpu/models/whisper.py:789",
        "launches": (default[name] + default_int16[name] + beam_int8[name] + routes[name]
                     + long_words[name]),
        **cross[name],
    } for name in ("cross_logits", "cross_mix")), {
        "name": "flash_attention",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention.cu",
        "replaces": "stt_tpu/models/whisper.py:378",
        "launches": (counts_30s["flash_attention"] + beam_30s["flash_attention"]
                     + routes["flash_attention"] + long_words["flash_attention"]
                     + train["bfloat16"]["forward_launches"]),
        "max_abs_err": flash_err,
        **flash_headline,
    }, {
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention.cu",
        "replaces": "stt_tpu/models/whisper.py:378",
        "launches": f32_launches + train["float32"]["forward_launches"],
        **flash32_headline,
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        **train["float32"]["dkv"],
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        **train["float32"]["dq"],
    }, {
        "name": "flash_attention_bwd_dkv_bf16",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        **train["bfloat16"]["dkv"],
    }, {
        "name": "flash_attention_bwd_dq_bf16",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        **train["bfloat16"]["dq"],
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
