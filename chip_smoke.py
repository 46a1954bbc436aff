#!/usr/bin/env python3
"""Drive stt_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card, nvcc and
PyTorch built for CUDA. In order:

1. prints the card's name and power limit, builds every kernel of the path
   from the sources in the checkout (``nvcc``, no network) and prints the
   build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and a few more, with the tolerance
   stated, and times kernel, plain version and one PyTorch library call;
3. builds a whisper-small ``WhisperEngine`` in bfloat16 at full width with
   random weights from seed 0, serves 8 concurrent requests (1, 2, 5 and
   10 s of synthetic audio) submitted from 8 threads, checks every output,
   and checks from the launch counts that the path ran through the kernels;
4. checks the outputs against a reference on a small input: the ``test``
   model in float32 on the card against the same model on the CPU;
5. closes the engine, then prints one JSON line describing each kernel and,
   last, ``{"ok": true, "device": {...}}``.

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
H100_F32_FLOPS = 67e12                   # CUDA-core float32 peak, SXM, 700 W
H100_HBM_BYTES = 3.35e12                 # HBM3 bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Speech-like test signal: a gliding harmonic tone with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 40.0 * seed + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (sig + 0.02 * rng.normal(0, 1, t.shape)).astype(np.float32)


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
    t0 = time.monotonic()
    build.load("mel")
    log(f"build: mel.cu with {build.find_nvcc()} in {time.monotonic() - t0:.1f} s")

    # -- 2. kernel vs plain ----------------------------------------------------
    def rows_for(wire: str, batch: int, seconds: float) -> torch.Tensor:
        audio = np.stack([synth_audio(seconds, seed=i) for i in range(batch)])
        if wire == "silence":
            audio = np.zeros_like(audio)
        pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        host = {"float32": audio, "int16": pcm}.get(wire)
        if host is None:  # mu-law, as the engine sends it (silence included)
            host = E._encode_wire_rows(pcm)
        return torch.from_numpy(np.ascontiguousarray(host)).to(dev)

    def library_logmel(rows: torch.Tensor) -> torch.Tensor:
        """The same function through torch.stft and a filterbank matmul."""
        audio = M.expand_wire(rows)
        spec = torch.stft(audio, M.N_FFT, M.HOP_LENGTH,
                          window=torch.hann_window(M.N_FFT, device=rows.device),
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec[..., :-1].abs() ** 2
        fb = torch.from_numpy(M.mel_filterbank(80)).to(rows.device)
        return torch.log10(torch.clamp_min(fb @ power, 1e-10))

    fb_nonzeros = int(np.count_nonzero(M.mel_filterbank(80)))

    def mel_bound_ms(rows: torch.Tensor, n_mels: int = 80):
        """Least time for the function's own work: a 400-point real FFT per
        frame (2.5 N log2 N flops), the window, the power, the filterbank's
        non-zeros and the log; each input byte read once, each output byte
        written once. The filterbank (a 64 KB constant) is not counted."""
        b, t = rows.shape
        frames = b * (t // M.HOP_LENGTH)
        n_bins = M.N_FFT // 2 + 1
        per_frame = (2.5 * M.N_FFT * np.log2(M.N_FFT) + M.N_FFT + 3 * n_bins
                     + 2 * fb_nonzeros + n_mels)
        nbytes = rows.numel() * rows.element_size() + frames * n_mels * 4
        t_ops, t_bytes = frames * per_frame / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    def mel_design_ms(rows: torch.Tensor, n_mels: int = 80) -> float:
        """This kernel's own arithmetic at the float32 peak: the DFT as a
        dense (400, 402) product plus a dense (201, n_mels) mel product."""
        b, t = rows.shape
        n_bins = M.N_FFT // 2 + 1
        flops = b * (t // M.HOP_LENGTH) * (M.N_FFT * 2 * n_bins * 2 + n_bins * n_mels * 2)
        return flops / H100_F32_FLOPS * 1e3

    # (batch, seconds) from 1 row of 1 s to 16 rows of 10 s and 4 of 30 s,
    # then the groups the served phase below forms (4 rows at each of the
    # 1/2/5/10 s buckets, mu-law)
    shapes = [(1, 1.0), (3, 5.0), (16, 10.0), (4, 30.0)]
    cases = [(b, s, w) for b, s in shapes for w in ("silence", "float32", "int16", "mulaw")]
    cases += [(4, s, "mulaw") for s in (1.0, 2.0, 5.0, 10.0)]
    mel_err = 0.0
    headline = None
    for batch, seconds, wire in cases:
        rows = rows_for(wire, batch, seconds)
        got = M.normalize_log_mel(mel_logspec(rows))
        ref = M.normalize_log_mel(log_mel_spectrogram_plain(rows))
        torch.cuda.synchronize()
        if got.shape != (batch, 80, int(seconds * 100)) or not torch.isfinite(got).all():
            fail(f"mel kernel output at {batch}x{seconds}s {wire}: shape "
                 f"{tuple(got.shape)} or non-finite values")
        err = (got - ref).abs().max().item()
        mel_err = max(mel_err, err)
        try:
            torch.testing.assert_close(got, ref, atol=MEL_ATOL, rtol=MEL_RTOL)
        except AssertionError as exc:
            fail(f"mel kernel disagrees with plain at {batch}x{seconds}s {wire}: {exc}")
        k_ms = cuda_ms(torch, lambda: mel_logspec(rows))
        p_ms = cuda_ms(torch, lambda: log_mel_spectrogram_plain(rows))
        l_ms = cuda_ms(torch, lambda: library_logmel(rows))
        b_ms, b_by = mel_bound_ms(rows)
        d_ms = mel_design_ms(rows)
        lib_err = (M.normalize_log_mel(library_logmel(rows)) - got).abs().max().item()
        log(f"mel_logspec {batch}x{seconds:g}s {wire:8s}: max_abs_err {err:.3g} "
            f"(library {lib_err:.3g}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {l_ms:.4f} ms, bound {b_ms:.3g} ms ({b_by}), dense-DFT "
            f"design's float32 floor {d_ms:.3g} ms")
        if (batch, seconds, wire) == (16, 10.0, "mulaw"):
            headline = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                            bound_by=b_by)

    # -- 3. served requests ----------------------------------------------------
    t0 = time.monotonic()
    engine = E.WhisperEngine(
        "small", device="cuda", compute_type="bfloat16",
        batch_buckets=(1, 4, 16, 64), batch_window_ms=50.0, max_decode_tokens=224,
    )
    cfg = engine.config
    log(f"engine: whisper-{cfg.name} bf16 d={cfg.n_text_state} layers "
        f"{cfg.n_audio_layer}+{cfg.n_text_layer} heads {cfg.n_text_head} vocab "
        f"{cfg.n_vocab}; built in {time.monotonic() - t0:.1f} s")
    try:
        # first call pays cuBLAS/cuDNN set-up; not part of the measured run
        t0 = time.monotonic()
        engine.transcribe_sync(E.DecodeRequest(synth_audio(1.0, 9), language="en"))
        log(f"warm-up request: {time.monotonic() - t0:.2f} s")

        durations = [1.0, 2.0, 5.0, 10.0] * 2
        requests = [
            E.DecodeRequest(synth_audio(d, seed=i), language=None if i % 2 else "en",
                            session_id=f"smoke-{i}", is_final=True)
            for i, d in enumerate(durations)
        ]
        barrier = threading.Barrier(len(requests))
        results = [None] * len(requests)
        errors = []

        def client(i: int) -> None:
            try:
                barrier.wait(timeout=60)
                t_sub = time.monotonic()
                out = engine.submit(requests[i]).result(timeout=300)
                results[i] = (out, time.monotonic() - t_sub)
            except Exception as exc:  # reported below; the phase fails
                errors.append(f"request {i}: {exc!r}")

        mel_logspec.launches = 0
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(requests))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=360)
        wall = time.monotonic() - t0
        launches = mel_logspec.launches
        if errors or any(t.is_alive() for t in threads) or None in results:
            fail(f"served requests did not all complete: {errors}")
        for i, (out, latency) in enumerate(results):
            toks = out._tokens
            gen = toks[out._p_len: out._p_len + out._n_gen]
            if (toks.min() < 0 or toks.max() >= cfg.n_vocab or out._n_gen > 224
                    or out._n_gen > E.max_new_for(engine._bucket_for(len(requests[i].audio)), 224)):
                fail(f"request {i}: malformed tokens (n_gen {out._n_gen})")
            if out.info.language not in W.WHISPER_LANG_CODES or not (
                    0.0 < out.info.language_probability <= 1.0):
                fail(f"request {i}: bad language {out.info}")
            if not (np.isfinite(out.avg_logprob) and 0.0 <= out.no_speech_prob <= 1.0):
                fail(f"request {i}: non-finite scores {out.avg_logprob} {out.no_speech_prob}")
            log(f"request {i}: {durations[i]:g} s audio, latency {latency:.3f} s, "
                f"batch_rows {out.batch_rows}, n_gen {out._n_gen}, language "
                f"{out.info.language} ({out.info.language_probability:.3f}), "
                f"first tokens {gen[:6].tolist()}")
        if max(out.batch_rows for out, _ in results) < 2:
            fail("no two requests shared a batch")
        if launches <= 0:
            fail("the served path never launched the mel kernel")
        log(f"served {len(requests)} requests in {wall:.3f} s; mel_logspec launches "
            f"{launches}")
    finally:
        engine.close()
    if engine._thread is not None or engine._harvest_thread is not None:
        fail("engine threads still running after close()")

    # -- 4. reference on a small input ------------------------------------------
    small = [E.DecodeRequest(synth_audio(s, seed=10 + i), language=lang)
             for i, (s, lang) in enumerate([(1.5, "en"), (0.7, None)])]
    outs = {}
    for name in ("cuda", "cpu"):
        eng = E.WhisperEngine("test", device=name, compute_type="float32")
        ctx = eng._device_phase([E._Task(r, None) for r in small])
        model = eng.model
        with torch.inference_mode():
            enc = E._mel_encode(model, ctx["rows_dev"], torch.float32)
        outs[name] = (ctx["packed"].cpu().numpy(), enc.cpu(), model)
        eng.close()
    enc_err = (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()
    if enc_err > REF_ATOL:
        fail(f"test-model encoder on the card vs CPU: max abs err {enc_err:.3g}")
    tokens = torch.from_numpy(outs["cpu"][0][:, :-5]).long()
    with torch.inference_mode():
        lg_gpu = W.decoder_forward(outs["cuda"][2], tokens.to(dev), outs["cpu"][1].to(dev)).cpu()
        lg_cpu = W.decoder_forward(outs["cpu"][2], tokens, outs["cpu"][1])
    logit_err = (lg_gpu - lg_cpu).abs().max().item()
    if not torch.isfinite(lg_gpu).all() or logit_err > REF_ATOL:
        fail(f"test-model decoder logits on the card vs CPU: max abs err {logit_err:.3g}")
    # greedy argmax may flip on a near-tie between two float32 runs, so token
    # identity is reported, and the gate is the teacher-forced logits above
    same_tokens = bool((outs["cuda"][0][:, :-5] == outs["cpu"][0][:, :-5]).all())
    log(f"reference (test model, float32): encoder max abs err {enc_err:.3g}, "
        f"teacher-forced logits max abs err {logit_err:.3g}, token rows "
        f"{'identical' if same_tokens else 'differ'} on the card and the CPU")

    # -- 5. result -------------------------------------------------------------
    kernels = [{
        "name": "mel_logspec",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/cuda/mel.cu",
        "replaces": "stt_tpu/ops/pallas/mel.py:84",
        "launches": launches,
        "max_abs_err": mel_err,
        **headline,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
