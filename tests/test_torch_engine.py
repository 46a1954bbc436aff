"""The port's serving slice as a whole against the JAX package's engine.

Both ``WhisperEngine("test", device="cpu", compute_type="float32")``
instances draw the same weights from seed 0 and serve the same groups of
mixed-length requests (some with a fixed language, some auto-detected).
Token rows, lengths and language indices in the packed result must be
identical, and so must the text and language of every output; the float
columns of the packed result (logprob sum, p(no_speech), language
probability) come out of different softmax implementations and are held
at rtol 1e-5. The rest checks the port's own contract: it imports no JAX,
it never falls back to the CPU, it refuses what this slice does not
serve, and its threads batch, resolve every future and stop.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stt_tpu.engine import engine as JE
from stt_tpu_torch import device as D
from stt_tpu_torch.backends.torch_whisper import TorchWhisperBackend
from stt_tpu_torch.engine import engine as TE

REPO = Path(__file__).resolve().parents[1]

# (seconds, language, seed): groups share an audio bucket, as the engines
# group them; lengths differ inside a group
GROUPS = [
    [(1.2, "en", 1), (1.9, None, 2), (1.5, "de", 3)],  # 2 s bucket, 4 rows
    [(0.6, None, 4)],                                   # 1 s bucket, 1 row
]


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


@pytest.fixture(scope="module")
def served():
    port = TE.WhisperEngine("test", device="cpu", compute_type="float32")
    ref = JE.WhisperEngine("test", device="cpu", compute_type="float32")
    results = []
    for group in GROUPS:
        t_tasks = [TE._Task(TE.DecodeRequest(_audio(s, seed), language=lang), None)
                   for s, lang, seed in group]
        j_tasks = [JE._Task(JE.DecodeRequest(_audio(s, seed), language=lang), None)
                   for s, lang, seed in group]
        t_ctx = port._device_phase(t_tasks)
        j_ctx = ref._device_phase(j_tasks)
        t_packed = t_ctx["packed"].numpy().copy()
        j_packed = np.array(j_ctx["packed"])
        results.append((t_packed, j_packed, port._harvest(t_ctx), ref._harvest(j_ctx)))
    yield port, results
    port.close()
    ref.close()


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_packed_token_rows_identical(served, gi):
    _, results = served
    t_packed, j_packed, _, _ = results[gi]
    assert t_packed.dtype == j_packed.dtype == np.int32
    assert t_packed.shape == j_packed.shape
    t_max = t_packed.shape[1] - 5
    int_cols = list(range(t_max + 1)) + [t_max + 3]  # tokens, length, lang idx
    np.testing.assert_array_equal(t_packed[:, int_cols], j_packed[:, int_cols])


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_packed_float_columns_close(served, gi):
    _, results = served
    t_packed, j_packed, _, _ = results[gi]
    t_max = t_packed.shape[1] - 5
    for col in (t_max + 1, t_max + 2, t_max + 4):
        np.testing.assert_allclose(t_packed[:, col].view(np.float32),
                                   j_packed[:, col].view(np.float32), rtol=1e-5)


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_outputs_identical(served, gi):
    _, results = served
    _, _, t_out, j_out = results[gi]
    assert len(t_out) == len(j_out) == len(GROUPS[gi])
    for t, j in zip(t_out, j_out):
        assert [s.text for s in t.segments] == [s.text for s in j.segments]
        assert [(s.start, s.end) for s in t.segments] == [(s.start, s.end) for s in j.segments]
        assert t.info.language == j.info.language
        assert t.info.language_probability == pytest.approx(j.info.language_probability, rel=1e-5)
        assert t.avg_logprob == pytest.approx(j.avg_logprob, rel=1e-5)
        assert t.no_speech_prob == pytest.approx(j.no_speech_prob, rel=1e-5)
        assert t.batch_rows == j.batch_rows
        assert t._n_gen == j._n_gen


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(stt_tpu_torch.__path__, 'stt_tpu_torch.')]\n"
        "assert {'stt_tpu_torch.ops.kernels.xattn_decode',\n"
        "        'stt_tpu_torch.ops.kernels.flash_attention',\n"
        "        'stt_tpu_torch.engine.graphs', 'stt_tpu_torch.bench'} <= set(names), names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stt_tpu.')) or m == 'stt_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 21


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the smoke script would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.WhisperEngine("test")
    assert D.resolve_device("cpu") == torch.device("cpu")


def test_unknown_device_name_raises():
    with pytest.raises(ValueError):
        D.resolve_device("tpu")


@pytest.mark.parametrize("options", [
    {"beam_size": 5},
    {"without_timestamps": False},
    {"temperature": [0.0, 0.2, 0.4]},
    {"temperature": 0.7},
    {"word_timestamps": True},
    {"prefix": "hello"},
    {"initial_prompt": "context"},
    {"repetition_penalty": 1.3},
    {"no_repeat_ngram_size": 3},
    {"clip_timestamps": "0,1"},
])
def test_unsupported_options_raise(served, options):
    port, _ = served
    req = TE.DecodeRequest(_audio(0.5, 9), language="en", options=options)
    name = next(iter(options))
    with pytest.raises(NotImplementedError, match=name):
        port.submit(req)
    with pytest.raises(NotImplementedError, match=name):
        port.transcribe_sync(req)


def test_default_options_are_served(served):
    port, _ = served
    out = port.transcribe_sync(TE.DecodeRequest(
        _audio(0.5, 9), language="en",
        options={"beam_size": 1, "temperature": 0.0, "without_timestamps": True},
    ))
    assert out.info.language == "en" and out.batch_rows == 1


def test_long_final_raises(served):
    port, _ = served
    req = TE.DecodeRequest(np.zeros(16000 * 31, np.float32), language="en", is_final=True)
    with pytest.raises(NotImplementedError, match="seek loop"):
        port.transcribe_sync(req)


def test_submit_batches_and_close_stops_threads():
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                           batch_window_ms=200.0, max_decode_tokens=8)
    barrier = threading.Barrier(4)
    futures = [None] * 4

    def send(i):
        barrier.wait(timeout=30)
        futures[i] = eng.submit(TE.DecodeRequest(_audio(0.8, 20 + i), language="en"))

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    outs = [f.result(timeout=120) for f in futures]
    assert max(o.batch_rows for o in outs) >= 2
    vocab = eng.config.n_vocab
    for o in outs:
        assert o._tokens.min() >= 0 and o._tokens.max() < vocab
        assert 0 <= o._n_gen <= 8
    engine_threads = [eng._thread, eng._harvest_thread]
    eng.close()
    for t in engine_threads:
        assert not t.is_alive()
    assert eng._thread is None and eng._harvest_thread is None


def test_backend_transcribe(served):
    port, _ = served
    backend = TorchWhisperBackend("test", engine=port)
    segments, info = backend.transcribe(_audio(1.2, 1), {"language": "en"})
    ref = port.transcribe_sync(TE.DecodeRequest(_audio(1.2, 1), language="en"))
    assert [s.text for s in segments] == [s.text for s in ref.segments]
    assert info.language == "en"


def test_engine_serves_30s_with_attention_options(monkeypatch):
    """A CPU engine with all three options set serves a 30 s request through
    both kernel routes (their plain versions here): flash once per encoder
    layer, cross-attention decode once per decoder layer and step."""
    from stt_tpu_torch.models import whisper as TW

    calls = {"flash_attention": 0, "xattn_decode": 0}
    for name in calls:
        real = getattr(TW, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(TW, name, spy)
    eng = TE.WhisperEngine("test", device="cpu", compute_type="bfloat16",
                           cross_kv_dtype="fp8", xattn_kernel="mm", flash_attention="auto",
                           max_decode_tokens=16)
    out = eng.transcribe_sync(TE.DecodeRequest(_audio(30.0, 5), language=None, is_final=True))
    cfg = eng.config
    max_new = TE.max_new_for(30.0, 16)
    assert calls["flash_attention"] == cfg.n_audio_layer
    # language detection + one step per generated position
    assert calls["xattn_decode"] == cfg.n_text_layer * (1 + max_new)
    assert out.batch_rows == 1 and 0 <= out._n_gen <= max_new
    assert out._tokens.min() >= 0 and out._tokens.max() < cfg.n_vocab
    assert out.info.language in TW.WHISPER_LANG_CODES
    assert np.isfinite(out.avg_logprob) and 0.0 <= out.no_speech_prob <= 1.0


# -- the audio wire and the pipeline depth ------------------------------------


def _tasks(module, group):
    return [module._Task(module.DecodeRequest(_audio(s, seed), language=lang), None)
            for s, lang, seed in group]


@pytest.fixture(scope="module")
def served_int16():
    """GROUPS served on the int16 wire by both engines. The JAX package's
    wire is its import-time module state, switched here by patching
    ``AUDIO_WIRE`` and ``_MULAW_LUT`` (nothing in stt_tpu/ is edited)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "AUDIO_WIRE", "int16")
        mp.setattr(JE, "_MULAW_LUT", None)
        port = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                                audio_wire="int16")
        ref = JE.WhisperEngine("test", device="cpu", compute_type="float32")
        results = []
        try:
            for group in GROUPS:
                t_ctx = port._device_phase(_tasks(TE, group))
                j_ctx = ref._device_phase(_tasks(JE, group))
                results.append((t_ctx["packed"].numpy().copy(), np.array(j_ctx["packed"]),
                                t_ctx["rows_dev"].numpy().copy()))
        finally:
            port.close()
            ref.close()
    return results


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_int16_wire_token_rows_identical(served_int16, gi):
    """The port's int16-wire engine gives the JAX int16-wire engine's
    tokens, lengths and languages, token for token."""
    t_packed, j_packed, rows = served_int16[gi]
    assert rows.dtype == np.int16
    assert t_packed.shape == j_packed.shape
    t_max = t_packed.shape[1] - 5
    int_cols = list(range(t_max + 1)) + [t_max + 3]
    np.testing.assert_array_equal(t_packed[:, int_cols], j_packed[:, int_cols])
    for col in (t_max + 1, t_max + 2, t_max + 4):
        np.testing.assert_allclose(t_packed[:, col].view(np.float32),
                                   j_packed[:, col].view(np.float32), rtol=1e-5)


def test_wires_feed_the_encoder_different_audio(monkeypatch):
    """With STT_AUDIO_WIRE=int16 the engine ships the lossless PCM16 rows
    (the reference's wire rows exactly), not mu-law codes, and the two
    wires give the encoder different log-mel inputs."""
    from stt_tpu_torch.ops.kernels.mel import log_mel_spectrogram_plain

    monkeypatch.setenv("STT_AUDIO_WIRE", "int16")
    wire16 = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                              max_decode_tokens=8)
    mulaw = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                             max_decode_tokens=8, audio_wire="mulaw")
    rows16 = wire16._device_phase(_tasks(TE, GROUPS[0]))["rows_dev"]
    rows_mu = mulaw._device_phase(_tasks(TE, GROUPS[0]))["rows_dev"]
    assert rows16.dtype == torch.int16 and rows_mu.dtype == torch.uint8
    pcm = np.zeros(tuple(rows16.shape), np.int16)
    for i, (s, _, seed) in enumerate(GROUPS[0]):
        a = _audio(s, seed)
        pcm[i, : len(a)] = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(rows16.numpy(), pcm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "_MULAW_LUT", None)
        np.testing.assert_array_equal(rows16.numpy(), JE._encode_wire_rows(pcm))
    np.testing.assert_array_equal(rows_mu.numpy(), JE._build_mulaw_lut()[pcm.view(np.uint16)])
    gap = (log_mel_spectrogram_plain(rows16) - log_mel_spectrogram_plain(rows_mu)).abs()
    assert gap.max().item() > 0.1


@pytest.mark.parametrize("env,wire", [(None, "mulaw"), ("", "mulaw"), (" MuLaw ", "mulaw"),
                                      ("int16", "int16"), (" INT16\n", "int16"),
                                      ("float32", "int16")])
def test_audio_wire_parses_as_the_reference(monkeypatch, env, wire):
    """STT_AUDIO_WIRE is stripped and lower-cased, empty means mulaw and any
    other value ships the int16 rows (``stt_tpu/engine/engine.py:68-89``)."""
    if env is None:
        monkeypatch.delenv("STT_AUDIO_WIRE", raising=False)
    else:
        monkeypatch.setenv("STT_AUDIO_WIRE", env)
    assert TE._audio_wire(None) == wire
    pcm = np.array([[0, 1000, -32768, 32767]], np.int16)
    lut = JE._build_mulaw_lut() if wire == "mulaw" else None
    ref = lut[pcm.view(np.uint16)] if lut is not None else pcm
    np.testing.assert_array_equal(TE._encode_wire_rows(pcm, TE._audio_wire(None)), ref)


@pytest.mark.parametrize("env,depth", [(None, 2), ("", 2), ("3", 3), ("0", 1), ("-4", 1),
                                       ("two", 2)])
def test_pipeline_depth_parses_as_the_reference(monkeypatch, env, depth):
    """STT_PIPELINE_DEPTH: default 2, unparsable 2, at least 1
    (``stt_tpu/engine/engine.py:1142-1147``)."""
    if env is None:
        monkeypatch.delenv("STT_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("STT_PIPELINE_DEPTH", env)
    assert TE._pipeline_depth(None) == depth


def test_wire_and_depth_read_once_at_build_and_argument_wins(monkeypatch):
    monkeypatch.delenv("STT_AUDIO_WIRE", raising=False)
    monkeypatch.delenv("STT_PIPELINE_DEPTH", raising=False)
    default = TE.WhisperEngine("test", device="cpu", compute_type="float32")
    assert (default.audio_wire, default.pipeline_depth) == ("mulaw", 2)

    monkeypatch.setenv("STT_AUDIO_WIRE", "int16")
    monkeypatch.setenv("STT_PIPELINE_DEPTH", "3")
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32", max_decode_tokens=8)
    assert (eng.audio_wire, eng.pipeline_depth) == ("int16", 3)
    assert eng._dispatch_sem._value == 3
    monkeypatch.setenv("STT_AUDIO_WIRE", "mulaw")
    monkeypatch.setenv("STT_PIPELINE_DEPTH", "1")
    assert eng._device_phase(_tasks(TE, GROUPS[1]))["rows_dev"].dtype == torch.int16
    assert (eng.audio_wire, eng.pipeline_depth) == ("int16", 3)

    given = TE.WhisperEngine("test", device="cpu", compute_type="float32",
                             audio_wire="int16", pipeline_depth=5)
    assert (given.audio_wire, given.pipeline_depth) == ("int16", 5)
    assert given._dispatch_sem._value == 5
    backend = TorchWhisperBackend("test", "cpu", "float32", audio_wire="int16",
                                  pipeline_depth=4)
    assert (backend.engine.audio_wire, backend.engine.pipeline_depth) == ("int16", 4)
