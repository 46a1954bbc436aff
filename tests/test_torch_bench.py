"""The port's bench (``stt_tpu_torch/bench.py``) on the CPU.

Its FLOP model is its own copy of ``bench.py``'s and must give the same
numbers for every preset and audio bucket (``bench.py``'s top level imports
only numpy, so the test loads it from its file). ``--device cpu --model
test`` runs the whole engine phase at a tiny size, then the partial-latency
phases (burst, served, draft acceptance, idle probe) at the test's stream
count, and prints one JSON line with the keys of ``bench.py``'s headline
and partial fields plus the port's own; the fields that only a card can
give are null there. With its end-to-end phase it also
boots the port's server on the CPU, drives it with the load tool and adds
the ``e2e_*`` fields. Nothing here times a card.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from stt_tpu_torch import bench as B
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models.presets import PRESETS
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PARTIAL_KEYS = {"partial_p95_loaded_ms", "partial_p50_loaded_ms", "partial_p95_iv_median_ms",
                "partial_burst_p95_ms", "partial_p95_ms", "draft_accept_rate", "draft_engaged",
                "draft_tick_ms"}
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "rtfx_best", "wall_median_s",
                 "mfu_pct", "ms_per_decode_step", "card"}


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_request_flops_equal_bench_py(root_bench, preset):
    config = PRESETS[preset]
    for bucket in TE.DEFAULT_AUDIO_BUCKETS_SEC:
        for p_len, gen in [(4, 1), (4, 37), (3, 224), (5, 0)]:
            assert B.whisper_request_flops(config, bucket, p_len, gen) == \
                root_bench.whisper_request_flops(config, bucket, p_len, gen)


def test_bench_prints_one_json_line_on_the_cpu():
    # two threads: the test workers already share the host's cores
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "stt_tpu_torch.bench", "--device", "cpu", "--model", "test",
         "--streams", "4", "--rounds", "1", "--no-e2e"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert HEADLINE_KEYS | {"rtfx_8streams", "graph_captures_serving"} <= set(result)
    assert result["metric"] == "rtfx_whisper_test_4streams"
    assert result["unit"] == "x_realtime_per_chip"
    assert result["value"] > 0 and result["rtfx_best"] >= result["value"]
    # both are rounded from the unrounded RTFx: value to 2 places, vs_baseline to 3
    assert abs(result["vs_baseline"] - result["value"] / 20.0) <= 1e-3
    assert result["card"] == "cpu" and result["device"] == "cpu"
    assert result["mfu_pct"] is None and result["ms_per_decode_step"] is None
    assert result["graph_captures_serving"] == 0
    assert PARTIAL_KEYS <= set(result)
    for key in PARTIAL_KEYS - {"draft_engaged", "draft_accept_rate"}:
        assert result[key] > 0, (key, result)
    assert result["draft_mode"] == "adaptive" and isinstance(result["draft_engaged"], bool)
    assert result["draft_accept_rate"] is None or 0.0 <= result["draft_accept_rate"] <= 1.0
    for phase in ("BURST partials", "SERVED partials", "streaming partial ticks",
                  "idle probe"):
        assert phase in out.stderr
    assert "left out" not in out.stderr
    assert not any(key.startswith("e2e_") for key in result)


E2E_KEYS = {"e2e_boot_s", "e2e_sessions", "e2e_error_rate", "e2e_create_p95_ms",
            "e2e_first_partial_p95_s", "e2e_final_p95_s"}


def test_bench_e2e_phase_on_the_cpu():
    """The E2E phase alone (``--e2e-only``): the engine and partial phases
    run in ``test_bench_prints_one_json_line_on_the_cpu``. Under ``--device
    cpu`` the load tool drives 4 x 2 sessions at 1x, which a host running
    other test workers serves inside the shipped 30 s decode timeout."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "stt_tpu_torch.bench", "--device", "cpu", "--model", "test",
         "--e2e-only"],
        cwd=REPO, capture_output=True, text=True, timeout=900, env=env,
    )
    # on a failure the bench's stderr carries the limit it hit, the server
    # log's tail and the load tool's stderr
    assert out.returncode == 0, out.stderr[-6000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert E2E_KEYS <= set(result) and "e2e_error" not in result, out.stderr[-6000:]
    assert B.E2E_LOAD_ARGS_CPU[:4] == ["--sessions", "4", "--iterations", "2"]
    assert result["e2e_sessions"] == 8 and result["e2e_error_rate"] == 0.0, out.stderr[-6000:]
    assert result["e2e_boot_s"] > 0 and result["e2e_create_p95_ms"] > 0, result
    for key in ("e2e_first_partial_p95_s", "e2e_final_p95_s"):
        assert result[key] is not None and result[key] > 0, (key, out.stderr[-6000:])
    # the card's load is unchanged
    assert B.E2E_LOAD_ARGS[:4] == ["--sessions", "16", "--iterations", "2"]
    assert B.E2E_LOAD_ARGS[B.E2E_LOAD_ARGS.index("--speed") + 1] == "2.0"
    assert not PARTIAL_KEYS & set(result) and "rtfx_best" not in result


def test_e2e_configs_narrow_the_shipped_matrix(tmp_path):
    server_path, model_path = B.e2e_configs(tmp_path)
    server = yaml.safe_load(server_path.read_text())
    model = yaml.safe_load(model_path.read_text())
    shipped = yaml.safe_load((REPO / "config" / "server.yaml").read_text())
    assert server["tpu"]["audio_buckets_sec"] == [5.0, 10.0]
    assert server["tpu"]["batch_buckets"] == [1, 16]
    assert server["server"]["max_decode_batch_size"] == 16
    assert sorted(model["model"]["decode_profiles"]) == ["realtime"]
    for section in ("vad", "auth", "health"):
        assert server[section] == shipped[section]


def test_bench_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        B.run(B.parse_args([]))


def test_profile_needs_the_card():
    with pytest.raises(RuntimeError, match="--profile"):
        B.run(B.parse_args(["--device", "cpu", "--model", "test", "--profile"]))


def test_defaults_are_the_headline_setup():
    args = B.parse_args([])
    assert (args.model, args.streams, args.secs, args.rounds, args.device, args.profile,
            args.e2e) == ("small", 64, 10.0, 9, "cuda", False, True)
    assert B.BATCH_BUCKETS == (1, 4, 16, 64, 128)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::xattn_decode_kernel<__nv_fp8_e4m3, __nv_bfloat16>(...)",
     "xattn_decode"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_bias_NNT", "matrix products, bf16"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float>",
     "matrix products, bf16"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x256x8_stage3", "matrix products, float32"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float>",
     "matrix products, float32"),
    ("void gemmSN_TN_kernel<float, 128, 16, 2, 4, 4, 4, true>", "matrix products, float32"),
    # bf16 operands, float32 accumulation and result (the out_dtype products)
    ("internal::gemvx::kernel<int, int, __nv_bfloat16, float, float, float, true, true>",
     "matrix products, bf16"),
    ("sm90_xmma_gemm_bf16f32_bf16f32_f32_nn_n_tilesize128x128x64_cgasize1x1x1",
     "matrix products, bf16"),
    ("void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_64x64_tn_align1>",
     "matrix products, bf16"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
     "copies and type conversions"),
    ("Memcpy HtoD (Pageable -> Device)", "copies and type conversions"),
    ("void at::native::vectorized_layer_norm_kernel<float, float, false>", "other"),
])
def test_kind_of_names(name, kind):
    assert B.kind_of(name) == kind


@pytest.fixture(scope="module")
def prewarmed():
    """A bf16 ``test`` engine with its 1 s x 4-row entries at beams 1 and 5."""
    eng = TE.WhisperEngine("test", device="cpu", compute_type="bfloat16", max_decode_tokens=16)
    eng.prewarm([1.0], [4], beam_sizes=[1, 5])
    return eng


def test_decode_step_bytes_counts_each_buffer_once(prewarmed):
    eng = prewarmed
    cfg = eng.config
    d, layers = cfg.n_text_state, cfg.n_text_layer
    # 3 layer norms, self and cross attention (4 d x d, 3 biases each), MLP
    per_layer = 3 * 2 * d + 2 * (4 * d * d + 3 * d) + 8 * d * d + 5 * d
    weights = 2 * (layers * per_layer + 2 * d)         # bf16, embedding tables left out
    t_max = 4 + TE.max_new_for(1.0, 16)
    cross = 2 * layers * 4 * 50 * d + 2 * layers * 4 * cfg.n_text_head * 4   # int8 + scales
    self_kv = 2 * 2 * layers * 4 * t_max * d                               # bf16
    table = 2 * cfg.n_vocab * d                                            # bf16, as stored
    expect = weights + table + cross + self_kv + 4 * cfg.n_vocab * 4
    assert B.decode_step_bytes(eng, 1.0, 4) == expect


def test_beam_step_bytes_count_the_cross_kv_once_a_row(prewarmed):
    """At beam 5 a step needs the self cache and the logits of rows x beam
    rows, but the cross K/V of its rows only once: the beams share it."""
    eng = prewarmed
    cfg = eng.config
    t_max = 4 + TE.max_new_for(1.0, 16)
    self_kv_row = 2 * 2 * cfg.n_text_layer * t_max * cfg.n_text_state      # bf16 K and V
    more_rows = 4 * 5 - 4
    assert B.decode_step_bytes(eng, 1.0, 4, beam=5) == (
        B.decode_step_bytes(eng, 1.0, 4) + more_rows * (self_kv_row + cfg.n_vocab * 4))
