"""The port's model registry, its engine keywords, resampler and runtime on the CPU.

The registry is a copy of the JAX package's but where the card differs, so
its fair queue is held to the original on one scripted sequence, and the
rest checks the port's own contract: device names, no serving on the CPU in
place of a missing card, the refusals (``mesh_shape``, ``draft_mode``,
``weights_path``, ``use_pallas=False`` on the card, the unported VAD
options), the engine's metrics hook and ``pad_to_30s``, and that a refusal
at submit time fails its task without stopping the dispatcher. The
resampler is held to the JAX package's ``resample_np`` at atol 1e-5.
"""

import time
from concurrent import futures

import numpy as np
import pytest
import torch

from stt_tpu.engine import registry as JR
from stt_tpu.ops.resample import resample_np as jax_resample_np
from stt_tpu_torch.backends import get_backend
from stt_tpu_torch.config.loader import load_config
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.engine import registry as TR
from stt_tpu_torch.ops.resample import resample, resample_np
from stt_tpu_torch.server.runtime.runtime import ApplicationRuntime
from stt_tpu_torch.utils.audio import float32_to_pcm16

CPU_TEST = {"backend": "torch_whisper", "model_size": "test", "device": "cpu",
            "compute_type": "float32"}


@pytest.mark.parametrize("src", [8000, 22050, 44100, 48000])
@pytest.mark.parametrize("shape", ["T", "BxT"])
def test_resample_matches_jax(src, shape):
    rng = np.random.default_rng(src)
    n = int(src * 0.9)
    audio = rng.normal(0, 0.3, (n,) if shape == "T" else (3, n)).astype(np.float32)
    want = jax_resample_np(audio, src, 16000)
    got = resample_np(audio, src, 16000)
    assert got.shape == want.shape == audio.shape[:-1] + (-(-n * 16000 // src),)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(resample(torch.from_numpy(audio), src, 16000).numpy(), got)


def test_resample_same_rate_is_identity():
    audio = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(resample_np(audio, 16000, 16000), audio)


def _script(queue_mod):
    """Pushes and pops on one queue; returns the popped (session, final)
    order and which tasks ended cancelled."""
    q = queue_mod.FairSessionQueue()
    tasks = []

    def push(sid, final=False):
        task = queue_mod._Task(pcm=b"\x00\x00" * 16, sample_rate=16000, options=None,
                               session_id=sid, is_final=final,
                               submitted_at=time.perf_counter(), future=futures.Future())
        tasks.append(task)
        q.push(task)

    order = []

    def pop(release=True):
        task = q.pop(timeout=0)
        order.append(None if task is None else (task.session_id, task.is_final))
        if task is not None and release:
            q.release(task.session_id)
        return task

    for sid in ("a", "a", "b", "c", "a"):
        push(sid)
    held = pop(release=False)       # a in flight
    pop()                           # b
    push("a", final=True)           # cancels a's queued partials
    pop()                           # c
    pop()                           # nothing dispatchable: a is in flight
    q.release(held.session_id)
    push("b")
    push("b", final=True)
    for _ in range(4):
        pop()
    return order, [t.future.cancelled() for t in tasks], q.depth()


def test_fair_queue_pops_the_jax_order():
    got, want = _script(TR), _script(JR)
    assert got == want
    assert any(got[1]) and got[2] == 0


@pytest.mark.parametrize("device", ["tpu", "cuda", "gpu", "cuda:0", None])
def test_card_device_without_cuda_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    options = {**CPU_TEST}
    if device is None:
        del options["device"]  # the registry's default is the card
    else:
        options["device"] = device
    registry = TR.ModelRegistry()
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.load_model("m", options)
    assert registry.list_models() == []


def test_unknown_device_name_raises():
    with pytest.raises(ValueError, match="unknown device"):
        TR.ModelRegistry().load_model("m", {**CPU_TEST, "device": "mps"})


@pytest.mark.parametrize("mesh", [(2, 1), (1, 4)])
def test_mesh_shape_raises(mesh):
    registry = TR.ModelRegistry(engine_defaults={"mesh_shape": mesh})
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        registry.load_model("m", CPU_TEST)


def test_draft_mode_raises():
    with pytest.raises(NotImplementedError, match="draft_mode"):
        TR.ModelRegistry().load_model("m", {**CPU_TEST, "draft_mode": "adaptive"})


def test_weights_path_raises():
    with pytest.raises(NotImplementedError, match="weights_path"):
        TE.WhisperEngine("test", device="cpu", compute_type="float32",
                         weights_path="/nonexistent")


def test_use_pallas_false_on_the_card_raises(monkeypatch):
    # a card as resolve_device would return it; the refusal comes before
    # anything is allocated there
    monkeypatch.setattr(TE, "resolve_device", lambda device: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="use_pallas"):
        TE.WhisperEngine("test", compute_type="float32", use_pallas=False)


def test_use_pallas_false_on_the_cpu_serves():
    engine = TE.WhisperEngine("test", device="cpu", compute_type="float32", use_pallas=False)
    out = engine.transcribe_sync(TE.DecodeRequest(np.zeros(8000, np.float32), language="en"))
    assert out.info.language == "en"


def test_pad_to_30s():
    engine = TE.WhisperEngine("test", device="cpu", compute_type="float32", pad_to_30s=True)
    assert engine.audio_buckets_sec == (30.0,)
    assert engine._bucket_for(16000) == 30.0


class _Metrics:
    def __init__(self):
        self.batches, self.compiles = [], []

    def record_engine_batch(self, rows, capacity, seconds):
        self.batches.append((rows, capacity, seconds))

    def record_engine_compile(self, seconds):
        self.compiles.append(seconds)


def test_metrics_hook_records_one_batch_per_group():
    metrics = _Metrics()
    engine = TE.WhisperEngine("test", device="cpu", compute_type="float32", metrics=metrics)
    groups = [[0.5, 0.7, 0.9], [1.5]]
    for group in groups:
        tasks = [TE._Task(TE.DecodeRequest(np.zeros(int(16000 * s), np.float32),
                                           language="en"), None) for s in group]
        engine._harvest(engine._device_phase(tasks))
    assert [(r, c) for r, c, _ in metrics.batches] == [(3, 4), (1, 1)]
    assert all(s > 0 for _, _, s in metrics.batches)
    assert metrics.compiles == []  # nothing is captured on the CPU


def test_engine_refusal_fails_its_task_and_the_dispatcher_survives():
    registry = TR.ModelRegistry()
    registry.load_model("default", CPU_TEST)
    try:
        pcm = float32_to_pcm16(np.zeros(8000, np.float32))
        refused = registry.submit_decode("default", "s1", pcm, 16000,
                                         {"language": "en", "beam_size": 5}, True)
        with pytest.raises(NotImplementedError, match="beam_size"):
            refused.result(timeout=60)
        served = registry.submit_decode("default", "s1", pcm, 16000, {"language": "en"}, True)
        result = served.result(timeout=120)
        assert result.language_code == "en" and result.audio_duration == 0.5
        pool = registry._pools["default"]
        assert isinstance(pool, TR.EnginePool) and pool._dispatcher.is_alive()
    finally:
        registry.close()


def test_resampled_decode_through_the_registry():
    registry = TR.ModelRegistry()
    registry.load_model("default", CPU_TEST)
    try:
        pcm = float32_to_pcm16(0.2 * np.sin(np.arange(8000) / 8000 * 2 * np.pi * 220)
                               .astype(np.float32))
        result = registry.submit_decode("default", "s1", pcm, 8000, {"language": "en"},
                                        True).result(timeout=120)
        assert result.audio_duration == 1.0
    finally:
        registry.close()


@pytest.mark.parametrize("name,cls", [("torch_whisper", "TorchWhisperBackend"),
                                      ("jax_whisper", "TorchWhisperBackend"),
                                      ("faster_whisper", "TorchWhisperBackend"),
                                      ("fake", "FakeBackend"), ("test", "FakeBackend")])
def test_backend_names(name, cls):
    assert get_backend(name).__name__ == cls


def test_fake_backend_pool_serves():
    registry = TR.ModelRegistry()
    registry.load_model("default", {"backend": "fake", "device": "cpu"})
    try:
        pcm = float32_to_pcm16(0.3 * np.ones(16000, np.float32))
        result = registry.submit_decode("default", "s", pcm, 16000, None, True).result(10)
        assert isinstance(registry._pools["default"], TR.ThreadPool)
        assert result.segments
    finally:
        registry.close()


@pytest.mark.parametrize("field,value,match", [("vad_model_path", "/x/silero.onnx",
                                                "vad_model_path"),
                                               ("vad_device", "device", "vad_device")])
def test_runtime_refuses_unported_vad_options(field, value, match):
    config = load_config()
    setattr(config, field, value)
    with pytest.raises(NotImplementedError, match=match):
        ApplicationRuntime(config, load_default_model=False)


def test_runtime_boots_the_shipped_config_with_host_vad():
    config = load_config()
    assert config.vad_device == "auto" and config.vad_model_path is None
    runtime = ApplicationRuntime(config, load_default_model=False)
    try:
        assert runtime.health_snapshot()["model_count"] == 0
    finally:
        runtime.shutdown()
