"""The port's engine on a (data, model) mesh against one device.

Counterpart of ``tests/test_engine.py:245-262, 280-297``: engines at (2, 4)
(the "test" config's 2 heads of 32 split 4 ways, inside a head) and (1, 2)
on CPU slots serve float32 transcripts and ``avg_logprob`` equal to a
single engine's; drafted partials, beam search, timestamps, the
temperature ladder, penalties, word timestamps and the seek loop of a long
final take their routes under the mesh with the single engine's tokens; a CPU mesh turns ``use_pallas`` off; int8 decoder
weights warn and are ignored under a mesh, and q/k/v are not fused, as the
JAX engine does.
"""

import logging

import numpy as np
import pytest
import torch

from stt_tpu_torch.engine.engine import DecodeRequest, WhisperEngine
from stt_tpu_torch.parallel.collectives import SlotColumn, SlotMLP, SlotRow
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

AUDIO = np.random.default_rng(4).normal(0, 0.1, 16000).astype(np.float32)


def _engine(**kw) -> WhisperEngine:
    return WhisperEngine("test", device="cpu", compute_type="float32",
                         max_decode_tokens=32, **kw)


def _text(out) -> str:
    return " ".join(s.text for s in out.segments)


def _tokens(out) -> list:
    """The generated tokens of a result."""
    return [int(t) for t in out._tokens[out._p_len:out._p_len + out._n_gen]]


@pytest.fixture(scope="module")
def single():
    eng = _engine()
    yield eng
    eng.close()


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)])
def test_mesh_engine_matches_single_device(single, shape):
    ref = single.transcribe_sync(DecodeRequest(audio=AUDIO, language="en"))
    eng = _engine(mesh_shape=shape)
    try:
        assert eng.mesh.shape == shape and len(eng.mesh.model_row(0)) == shape[1]
        attn = eng.model.encoder.blocks[0].attn
        assert isinstance(attn.q.shard, SlotColumn) and isinstance(attn.o.shard, SlotRow)
        assert isinstance(eng.model.decoder.blocks[1].mlp.shard, SlotMLP)
        out = eng.transcribe_sync(DecodeRequest(audio=AUDIO, language="en"))
    finally:
        eng.close()
    assert _text(out) == _text(ref)
    assert _tokens(out) == _tokens(ref) and len(_tokens(ref)) > 0
    assert abs(out.avg_logprob - ref.avg_logprob) < 1e-5


def test_drafted_partials_under_the_mesh(single):
    ref = single.transcribe_sync(DecodeRequest(audio=AUDIO, language="en"))
    eng = _engine(mesh_shape=(2, 2), draft_mode="on")
    try:
        outs = [eng.transcribe_sync(DecodeRequest(audio=AUDIO, language="en", is_final=False,
                                                  session_id="s"))
                for _ in range(2)]
        accepted = eng.draft_stats["accepted"]
    finally:
        eng.close()
    assert all(_text(o) == _text(ref) for o in outs)
    assert accepted > 0


@pytest.mark.parametrize("options", [
    {"beam_size": 5},
    {"without_timestamps": False},
    {"temperature": [0.0, 0.2], "best_of": 2, "log_prob_threshold": 0.0},
    {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3},
    {"word_timestamps": True, "no_speech_threshold": None},
], ids=["beam5", "timestamps", "ladder", "penalties", "words"])
def test_decode_routes_under_the_mesh(single, options):
    def req():
        return DecodeRequest(audio=AUDIO, language="en", options=dict(options))

    ref = single.transcribe_sync(req())
    eng = _engine(mesh_shape=(1, 4))
    try:
        out = eng.transcribe_sync(req())
    finally:
        eng.close()
    assert _tokens(out) == _tokens(ref) and len(_tokens(ref)) > 0
    assert [(s.start, s.end, s.text) for s in out.segments] == \
        [(s.start, s.end, s.text) for s in ref.segments]
    assert out.words == ref.words


def test_the_seek_loop_under_the_mesh(single):
    """A final longer than the largest bucket: windows through the queue."""
    audio = np.random.default_rng(5).normal(0, 0.1, 16000 * 34).astype(np.float32)
    ref = single.transcribe_sync(DecodeRequest(audio=audio, language="en"))
    eng = _engine(mesh_shape=(1, 2))
    try:
        out = eng.transcribe_sync(DecodeRequest(audio=audio, language="en"))
    finally:
        eng.close()
    assert [(s.start, s.end, s.text) for s in out.segments] == \
        [(s.start, s.end, s.text) for s in ref.segments]
    assert len(ref.segments) > 0


def test_use_pallas_is_off_on_a_cpu_mesh():
    eng = _engine(mesh_shape=(2, 4), use_pallas=True)
    try:
        assert eng.use_pallas is False
        out = eng.transcribe_sync(DecodeRequest(audio=np.zeros(16000, np.float32),
                                                language="en"))
    finally:
        eng.close()
    assert out.batch_rows == 1


def test_decoder_weight_policies_are_ignored_under_a_mesh(monkeypatch, caplog):
    monkeypatch.setenv("STT_DECODER_WEIGHTS_DTYPE", "int8")
    monkeypatch.setenv("STT_FUSED_QKV", "on")
    with caplog.at_level(logging.WARNING, logger="stt_tpu_torch"):
        eng = WhisperEngine("test", device="cpu", compute_type="bfloat16",
                            max_decode_tokens=8, mesh_shape=(1, 2))
    try:
        assert "ignored under a mesh" in caplog.text
        assert eng.decoder_policy.weights == "bf16" and not eng.decoder_policy.fused_qkv
        block = eng.model.decoder.blocks[0]
        assert block.attn.qkv is None and block.attn.q.wq is None
        out = eng.transcribe_sync(DecodeRequest(audio=AUDIO, language="en"))
    finally:
        eng.close()
    assert out.batch_rows == 1


def test_mesh_needs_as_many_slots_as_its_shape():
    with pytest.raises(ValueError, match="device count"):
        _engine(mesh_shape=(2, 2), mesh_devices=["cpu"] * 3)
    eng = _engine(mesh_shape=(1, 1))
    try:
        assert eng.mesh is None and eng.device == torch.device("cpu")
    finally:
        eng.close()
