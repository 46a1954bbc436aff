"""The switches of the JAX package read at engine build.

``STT_DECODER_WEIGHTS_DTYPE``, ``STT_FUSED_QKV``, ``STT_SELF_KV_DTYPE`` and
``STT_PREFILL`` select the decoder policies; they are parsed as the JAX
package parses them (``stt_tpu/models/whisper.py:353-366, 504-512,
571-580``) into the engine's frozen
:class:`~stt_tpu_torch.models.whisper.DecoderPolicy`, and every value
builds an engine that serves (``tests/test_torch_policies.py`` holds each
policy's numbers to the JAX package's). int8 weights under float32 compute
warn and are ignored, as in the JAX engine; a value that means the default
builds silently. ``STT_DRAFT_PARTIALS`` (``stt_tpu/engine/engine.py:
116-137``) is served: on/always/1/yes -> ``on``, off/no -> ``off``,
adaptive/auto and the default -> ``adaptive``, each building silently and
serving; any other value warns once and means ``adaptive``. A
``test``-model engine on the CPU.
"""

import logging

import pytest

from stt_tpu_torch.engine import engine as TE
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

SWITCHES = ("STT_DRAFT_PARTIALS", "STT_DECODER_WEIGHTS_DTYPE", "STT_FUSED_QKV",
            "STT_SELF_KV_DTYPE", "STT_PREFILL")

DRAFT_ON = [("on", "bfloat16"), ("always", "bfloat16"), ("1", "float32"),
            (" Yes ", "float32")]

# each value that the port once refused, and the policy it now builds
SERVED = [
    ("STT_DECODER_WEIGHTS_DTYPE", "int8", "bfloat16"),
    ("STT_DECODER_WEIGHTS_DTYPE", "int8_native", "bfloat16"),
    ("STT_DECODER_WEIGHTS_DTYPE", "i8", "bfloat16"),
    ("STT_DECODER_WEIGHTS_DTYPE", "I8N", "bfloat16"),
    ("STT_FUSED_QKV", "on", "bfloat16"),
    ("STT_FUSED_QKV", "true", "float32"),
    ("STT_SELF_KV_DTYPE", "fp8", "bfloat16"),
    ("STT_SELF_KV_DTYPE", "fp8_e4m3", "bfloat16"),
    ("STT_PREFILL", "seq", "bfloat16"),
    ("STT_PREFILL", "SEQ", "float32"),
]

PASSING = [
    ("STT_DRAFT_PARTIALS", "off", "bfloat16"),
    ("STT_DRAFT_PARTIALS", "no", "float32"),
    ("STT_DECODER_WEIGHTS_DTYPE", "bf16", "bfloat16"),
    ("STT_DECODER_WEIGHTS_DTYPE", "", "bfloat16"),
    ("STT_DECODER_WEIGHTS_DTYPE", "fp16", "bfloat16"),
    ("STT_FUSED_QKV", "off", "bfloat16"),
    ("STT_FUSED_QKV", "0", "float32"),
    ("STT_SELF_KV_DTYPE", "bf16", "bfloat16"),
    ("STT_SELF_KV_DTYPE", "fp8", "float32"),
    ("STT_PREFILL", "parallel", "bfloat16"),
    ("STT_PREFILL", "anything", "float32"),
]


@pytest.fixture
def env(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("STT_DRAFT_PARTIALS", "off")
    return monkeypatch


def _engine(compute_type):
    engine = TE.WhisperEngine("test", device="cpu", compute_type=compute_type)
    engine.close()
    return engine


def _warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno == logging.WARNING and r.name == "stt_tpu_torch"]


POLICY_FIELD = {
    "STT_DECODER_WEIGHTS_DTYPE": ("weights", {"int8": "int8", "i8": "int8",
                                              "int8_native": "int8_native", "i8n": "int8_native"}),
    "STT_FUSED_QKV": ("fused_qkv", {"on": True, "true": True}),
    "STT_SELF_KV_DTYPE": ("self_kv", {"fp8": "fp8", "fp8_e4m3": "fp8"}),
    "STT_PREFILL": ("prefill", {"seq": "seq"}),
}


@pytest.mark.parametrize("name,value,compute_type", SERVED)
def test_policy_values_build_and_serve(env, name, value, compute_type):
    """Each value the port once refused builds its policy and serves a
    greedy and a beam request."""
    env.setenv(name, value)
    engine = TE.WhisperEngine("test", device="cpu", compute_type=compute_type,
                              max_decode_tokens=16)
    field_name, expect = POLICY_FIELD[name]
    assert getattr(engine.decoder_policy, field_name) == expect[value.strip().lower()]
    assert engine.model.decoder.decoder_policy == engine.decoder_policy
    try:
        for options in ({}, {"beam_size": 2}):
            out = engine.transcribe_sync(TE.DecodeRequest(audio=_tone(), language="en",
                                                          options=options))
            assert out.info.language == "en" and 0 < out._n_gen <= 16
    finally:
        engine.close()


@pytest.mark.parametrize("name,value,compute_type", PASSING)
def test_passing_values_build_silently(env, caplog, name, value, compute_type):
    env.setenv(name, value)
    caplog.set_level(logging.WARNING, logger="stt_tpu_torch")
    assert _engine(compute_type).model is not None
    assert _warnings(caplog) == []


@pytest.mark.parametrize("value,compute_type", DRAFT_ON)
def test_draft_on_values_build_the_on_mode(env, caplog, value, compute_type):
    """The values that once were refused now serve drafted partials."""
    env.setenv("STT_DRAFT_PARTIALS", value)
    caplog.set_level(logging.WARNING, logger="stt_tpu_torch")
    engine = _engine(compute_type)
    assert engine._draft_mode == "on" and engine._draft_engaged
    assert _warnings(caplog) == []


@pytest.mark.parametrize("value", ["adaptive", "auto", None])
def test_adaptive_builds_silently_and_serves(env, caplog, value):
    if value is None:
        env.delenv("STT_DRAFT_PARTIALS")  # the shipped default is adaptive
    else:
        env.setenv("STT_DRAFT_PARTIALS", value)
    caplog.set_level(logging.WARNING, logger="stt_tpu_torch")
    engine = TE.WhisperEngine("test", device="cpu", compute_type="float32")
    try:
        assert _warnings(caplog) == []
        assert engine._draft_mode == "adaptive" and not engine._draft_engaged
        engine.start()
        out = engine.submit(TE.DecodeRequest(audio=_tone(), language="en",
                                             session_id="adaptive-1")).result(120)
        assert out.segments is not None
        assert len(engine._draft_get("adaptive-1")) == out._n_gen
    finally:
        engine.close()


def test_unrecognised_draft_value_falls_back_to_adaptive(env, caplog):
    """As the JAX package: one warning naming the value, then ``adaptive``."""
    env.setenv("STT_DRAFT_PARTIALS", "sometimes")
    caplog.set_level(logging.WARNING, logger="stt_tpu_torch")
    engine = _engine("float32")
    warned = _warnings(caplog)
    assert len(warned) == 1
    assert "unrecognized STT_DRAFT_PARTIALS='sometimes'" in warned[0]
    assert engine._draft_mode == "adaptive"


def test_int8_weights_under_float32_warn_and_serve(env, caplog):
    """The JAX package ignores int8 decoder weights under float32 compute
    with a warning; so does the port."""
    env.setenv("STT_DECODER_WEIGHTS_DTYPE", "int8")
    caplog.set_level(logging.WARNING, logger="stt_tpu_torch")
    _engine("float32")
    warned = _warnings(caplog)
    assert len(warned) == 1 and "requires bfloat16" in warned[0]


def _tone():
    import numpy as np

    t = np.arange(16000) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
