"""The p95, rate, spread and FLOP arithmetic against hand-worked cases; the
import check; the manifest finding new files by name."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run as harness
from benchmark.core import flops as FL
from benchmark.core import manifest
from benchmark.core import readers as READERS
from benchmark.core.records import Recorder, Req, Run
from benchmark.core.stats import percentile, spread, union_length
from benchmark.core.trace import DeviceOp, Trace

ROOT = Path(__file__).resolve().parents[2]
SMALL = json.loads((ROOT / "benchmark" / "configs" / "whisper-small.json").read_text())


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))          # 1..100
    assert percentile(values, 95) == 95
    assert percentile(values, 50) == 50
    assert percentile([7.0], 95) == 7.0
    assert percentile([3, 1, 2], 95) == 3  # ceil(2.85) = 3rd of 3
    with pytest.raises(ValueError):
        percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    # statistics.quantiles([1..6], n=4) (exclusive method) -> 1.75, 3.5, 5.25
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_union_length_merges_overlaps():
    assert union_length([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert union_length([]) == 0.0


def _req(kind, due, done, audio_s=1.0, inference=0.1, n_gen=10, error=None):
    out = SimpleNamespace(inference_sec=inference, _p_len=4, _n_gen=n_gen,
                          _tokens=np.zeros(4 + 24, np.int32), avg_logprob=-1.0)
    return Req(kind=kind, session="s", due=due, audio=np.zeros(int(audio_s * 16000), np.float32),
               options={}, sent=due, done=done, output=None if error else out, error=error)


def _run(reqs, window=(10.0, 20.0), trace=None):
    return Run(cell="c", config=SMALL, traffic={}, seconds=10.0, window=window,
               deadline=window[1] + 5.0, requests=reqs, recorder=Recorder(), trace=trace)


def _reader(name):
    return manifest.reader({"name": name}, ROOT)


def test_latency_p95_counts_failures_as_waiting_until_the_deadline():
    reqs = [_req("partial", 10.0 + 0.05 * i, 10.0 + 0.05 * i + 0.1) for i in range(19)]
    reqs.append(_req("partial", 11.0, None, error="RuntimeError: boom"))
    reqs.append(_req("partial", 5.0, 5.2))         # due before the window
    run = _run(reqs)
    # 20 counted: 19 at 100 ms and one failed, waiting 25 - 11 = 14 s at least
    assert _reader("partial_p95_ms").read(run) == pytest.approx(100.0)
    assert _reader("partial_p95_ms.live").read(run) == pytest.approx(100.0)
    reqs.append(_req("partial", 12.0, None, error="RuntimeError: boom"))
    assert _reader("partial_p95_ms").read(_run(reqs)) == pytest.approx(13000.0)
    assert _reader("final_p95_ms").read(run) is None


def test_final_wait_takes_the_group_time_off_the_latency():
    reqs = [_req("final", 10.0 + i, 10.0 + i + 0.5, inference=0.2) for i in range(5)]
    assert _reader("final_wait_p95_ms.live").read(_run(reqs)) == pytest.approx(300.0)


def test_partial_group_median_is_over_the_partials_group_times():
    reqs = [_req("partial", 10.0 + i, 10.5 + i, inference=0.1 * (1 + i // 2)) for i in range(6)]
    reqs.append(_req("final", 12.0, 13.0, inference=9.0))
    # groups of two partials at 0.1, 0.2 and 0.3 s; the final is not a partial
    assert _reader("partial_group_ms_p50.live").read(_run(reqs)) == pytest.approx(200.0)


def test_request_flops_by_hand():
    cfg = {"d_model": 2, "num_mel_bins": 1, "encoder_layers": 1, "decoder_layers": 1,
           "vocab_size": 3}
    # bucket 0.02 s: 2 mel frames, 1 encoder position; 1 prompt token, 1 generated
    ta, tm, d, steps = 1, 2, 2, 2
    enc = 2 * 3 * 1 * d * tm + 2 * 3 * d * d * (tm // 2) + (
        2 * 4 * ta * d * d + 2 * 2 * ta * ta * d + 2 * 8 * ta * d * d)
    cross = 2 * 2 * ta * d * d
    step = (2 * 4 * d * d + 2 * 2 * d * d + 2 * 8 * d * d + 2 * 2 * steps * d
            + 2 * 2 * ta * d) + 2 * d * 3
    assert FL.request_flops(cfg, 0.02, 1, 1) == enc + cross + steps * step
    assert FL.request_flops(cfg, 0.02, 1, 1, beams=5) == enc + cross + 5 * steps * step


def test_mel_least_time():
    # 16 rows of 10 s on the mu-law wire: operations bind it
    least = FL.mel_least_seconds(16, 10.0, 80, 1, FL.mel_nonzeros(80))
    assert least == pytest.approx(2.51e-6, rel=0.02)


def test_trace_readers_by_hand():
    mel = "void (anonymous namespace)::mel_fft_kernel<unsigned char>(unsigned char const*)"
    # each launch with the host time of the call that launched it
    ops = [DeviceOp("ampere_bf16_gemm", 0.0, 0.4), DeviceOp(mel, 0.5, 0.5 + 1e-4, True, 0.11),
           DeviceOp(mel, 0.98, 0.98 + 1e-4, True, 0.96)]
    trace = Trace(0.0, 1.0, ops, [("cudaStreamSynchronize", 0.45, 0.95)])
    run = _run([], window=(0.0, 1.0), trace=trace)
    assert _reader("device_idle_pct.live").read(run) == pytest.approx(100 * (1 - 0.4002))
    gaps = trace.idle_gaps(3)
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(0.48 - 1e-4)
    # a 3-row group of 4 s requests (the 5 s bucket, padded to the 4-row
    # rung) wholly in the stretch, then a lone 8 s request (10 s, 1 row)
    reqs = [_req("partial", 0.0, 0.9, audio_s=4.0, inference=0.8, n_gen=20) for _ in range(3)]
    late = _req("final", 0.0, 1.2, audio_s=8.0, inference=0.25, n_gen=20)
    run = _run(reqs + [late], window=(0.0, 1.0), trace=trace)
    # the engine reports each group at its harvest's end: (time, rows, rung, seconds)
    batches = [(0.9, 3, 4, 0.8), (1.2, 1, 1, 0.25)]
    run.recorder.batches = list(batches)
    want = 100 * (FL.mel_least_seconds(4, 5.0, 80, 1, FL.mel_nonzeros(80))
                  + FL.mel_least_seconds(1, 10.0, 80, 1, FL.mel_nonzeros(80))) / 2e-4
    assert _reader("mel_roofline.live").read(run) == pytest.approx(want)
    run = _run(reqs, window=(0.0, 1.0), trace=trace)    # a launch with no group
    run.recorder.batches = list(batches)
    assert _reader("mel_roofline.live").read(run) is None
    # two launches called inside one group's device phase: not one a group
    twice = Trace(0.0, 1.0, [DeviceOp(mel, 0.9, 0.96, True, 0.2),
                             DeviceOp(mel, 0.98, 0.99, True, 0.3)], [])
    run2 = _run(reqs + [late], window=(0.0, 1.0), trace=twice)
    run2.recorder.batches = list(batches)
    assert _reader("mel_roofline.live").read(run2) is None
    # a launch whose host call the trace does not hold
    lost = Trace(0.0, 1.0, [DeviceOp(mel, 0.98, 0.99)], [])
    run3 = _run(reqs + [late], window=(0.0, 1.0), trace=lost)
    run3.recorder.batches = list(batches)
    assert _reader("mel_roofline.live").read(run3) is None
    # the group wholly in the stretch: its FLOPs over the busy time across it
    work = 3 * FL.request_flops(SMALL, 5.0, 4, 21)
    assert _reader("mfu_pct.live").read(run) == pytest.approx(
        100 * work / (0.4 - 0.1 + 1e-4) / FL.H100_BF16_FLOPS)


def test_mel_launches_pair_by_their_host_call_though_the_card_runs_them_late():
    mel = "void (anonymous namespace)::mel_fft_kernel<unsigned char>(unsigned char const*)"
    # device phases start every 5 ms and each calls the launch 1 ms in; the
    # card runs each kernel 80 ms later, queued behind the groups before it
    reqs, batches, ops = [], [], []
    for g in range(8):
        start, inference = 1.0 + 0.005 * g, 0.2 + g * 1e-6
        for _ in range(2):
            reqs.append(_req("partial", 0.0, start + inference, audio_s=4.0, inference=inference))
        batches.append((start + inference, 2, 64, inference))
        if g >= 3:    # the stretch holds the last five groups' launches
            ops.append(DeviceOp(mel, start + 0.08, start + 0.08 + 1e-4, True, start + 0.001))
    trace = Trace(1.05, 2.0, ops, [])
    run = _run(reqs, window=(0.0, 2.0), trace=trace)
    run.recorder.batches = batches
    pairs = READERS.mel_pairs(run)
    assert [g[0] for _, g in pairs] == pytest.approx([1.0 + 0.005 * g for g in range(3, 8)],
                                                     abs=1e-6)
    want = 100 * FL.mel_least_seconds(64, 5.0, 80, 1, FL.mel_nonzeros(80)) / 1e-4
    assert _reader("mel_roofline.live").read(run) == pytest.approx(want)


def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_imports({"stt_tpu_torch": 1, "stt_tpu_torch.engine": 1,
                                      "numpy": 1}) == []
    assert harness.forbidden_imports({"stt_tpu_torch": 1, "stt_tpu.x": 1}) == ["stt_tpu"]
    assert harness.forbidden_imports({"jaxlib.xla": 1, "flax": 1, "jax_x": 1}) == [
        "flax", "jaxlib"]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = dict(SMALL, name="whisper-small-copy")
    (tmp_path / "benchmark" / "configs" / "whisper-small-copy.json").write_text(json.dumps(config))
    mix = json.loads((ROOT / "benchmark" / "traffic" / "small.live.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "copy.burst.json").write_text(
        json.dumps(dict(mix, sessions=3)))
    (tmp_path / "benchmark" / "metrics" / "sessions_seen.live.py").write_text(
        "def read(run):\n    return float(run.traffic['sessions'])\n")
    bench["configs"].append({"name": "whisper-small-copy", "source": "https://example.org",
                             "file": "benchmark/configs/whisper-small-copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "copy.burst", "config": "whisper-small-copy",
                               "traffic": "copy.burst", "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "sessions_seen.live", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "engine queue",
                               "moves": "final_p95_ms", "workloads": ["copy.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("copy.burst", True, tmp_path)
    assert cell.config["name"] == "whisper-small-copy"
    assert cell.traffic["sessions"] == 3 and cell.generator.__name__.endswith("live")
    assert [m["name"] for m in cell.metrics] == ["sessions_seen.live"]
    run = _run([])
    run.traffic = cell.traffic
    assert manifest.read_metric(cell.metrics[0], run, tmp_path) == 3.0
    with pytest.raises(KeyError):
        manifest.load_cell("no.such.cell", False, tmp_path)
