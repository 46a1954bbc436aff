"""Word timestamps in the port against the JAX package.

On the CPU in float32:

- the port's copy of the timing module (``stt_tpu_torch/models/timing.py``)
  gives ``stt_tpu.models.timing``'s results exactly on seeded inputs:
  median filter, DTW path, token jump times, word grouping and the whole
  alignment;
- ``cross_attention_weights`` gives the JAX function's maps within atol
  1e-5, with float32 cross K/V and with int8 cross K/V (both packages are
  handed one set of int8 codes and scales, so the check holds the
  dequantisation and the pass, not two quantisations of float32 values
  that may round one code apart);
- the engine's words equal the JAX engine's (text exactly, times within
  1e-6) on greedy, beam 5 and timestamp decodes of one group, and on a long
  final whose windows shift the words by their offsets; segments equal
  exactly. A DTW tie that the ~1e-6 differences of the maps flip would
  show as a word time one frame (0.02 s) apart; the message then prints
  both word lists.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.engine import engine as JE
from stt_tpu.models import timing as JT
from stt_tpu.models import whisper as JW
from stt_tpu.models.tokenizer import FallbackTokenizer as JFallback
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import timing as TT
from stt_tpu_torch.models import whisper as TW
from stt_tpu_torch.models.tokenizer import FallbackTokenizer as TFallback
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ENGINE_KW = dict(device="cpu", compute_type="float32", audio_buckets_sec=(1.0, 2.0),
                 batch_buckets=(1, 4), max_decode_tokens=16)
NO_SILENCE = {"word_timestamps": True, "no_speech_threshold": None}


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


# -- the timing module ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timing_copy_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 40))
    for width in (1, 3, 7, 41):
        np.testing.assert_array_equal(TT.median_filter(x, width), JT.median_filter(x, width))
    cost = rng.random((9, 30))
    for got, ref in zip(TT.dtw_path(cost), JT.dtw_path(cost)):
        np.testing.assert_array_equal(got, ref)
    matrix = rng.random((6, 50)).astype(np.float32)
    np.testing.assert_array_equal(TT._token_jump_times(matrix, 37),
                                  JT._token_jump_times(matrix, 37))
    ids = [int(i) for i in rng.integers(0, 2000, 8)]
    t_tok, j_tok = TFallback(51865), JFallback(51865)
    assert TT.group_word_tokens(ids, t_tok) == JT.group_word_tokens(ids, j_tok)
    weights = rng.random((4, 12, 60)).astype(np.float32)
    positions = sorted(rng.choice(12, 8, replace=False).tolist())
    got = TT.word_alignments(weights, ids, positions, t_tok, 1.1)
    ref = JT.word_alignments(weights, ids, positions, j_tok, 1.1)
    assert [tuple(w) for w in got] == [tuple(w) for w in ref]


# -- the teacher-forced pass ---------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, torch.device("cpu"))
    jparams = JW.init_params(JW.get_config("test"), seed=0)
    rng = np.random.default_rng(3)
    mel = rng.normal(0, 1, (2, config.n_mels, 200)).astype(np.float32)
    enc = np.array(JW.encode(jparams, jnp.asarray(mel), config.n_audio_head))
    prompt = TW.build_prompt(config, "en")
    tokens = np.concatenate([np.tile(prompt, (2, 1)), rng.integers(0, 50000, (2, 11))],
                            axis=1).astype(np.int64)
    return config, model, jparams, enc, tokens


def _int8_cross_kv(model, enc):
    """float32 cross K/V quantised per (layer, row, head) as both packages
    quantise them."""
    ckv = TW.precompute_cross_kv(model.decoder, enc)
    k, ks = zip(*(TW._q8(ckv.k[li]) for li in range(ckv.k.shape[0])))
    v, vs = zip(*(TW._q8(ckv.v[li]) for li in range(ckv.v.shape[0])))
    return TW.CrossKV(torch.stack(k), torch.stack(v), torch.stack(ks), torch.stack(vs))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_cross_attention_weights_equal_jax(pair, storage, monkeypatch):
    config, model, jparams, enc, tokens = pair
    enc_t = torch.from_numpy(enc)
    if storage == "int8":
        fixed = _int8_cross_kv(model, enc_t)
        assert fixed.k.dtype == torch.int8 and fixed.k_scale.shape[-2:] == (1, 1)
        monkeypatch.setattr(TW, "precompute_cross_kv", lambda dec, enc_out: fixed)
        monkeypatch.setattr(JW, "precompute_cross_kv", lambda params, enc_out, n_head: JW.CrossKV(
            *(jnp.asarray(x.numpy()) for x in fixed)))
        # a new shape, so the jitted function traces the patched K/V
        tokens = tokens[:, :-1]
    got = TW.cross_attention_weights(model, torch.from_numpy(tokens), enc_t, n_align_layers=2)
    ref = np.asarray(JW.cross_attention_weights(jparams, jnp.asarray(tokens, jnp.int32),
                                                jnp.asarray(enc), config.n_text_head,
                                                n_align_layers=2))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (2, 2, config.n_text_head, tokens.shape[1], 100)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_bf16_cross_attention_weights_are_maps():
    """Under bfloat16 compute the default int8 cross K/V are dequantised
    before the pass; the maps are float32 rows of a softmax."""
    config = TW.get_config("test")
    model = TW.build_model(config, TW.init_params(config, seed=0), torch.device("cpu"),
                           torch.bfloat16)
    enc = torch.randn(2, 50, config.n_audio_state, generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor([TW.build_prompt(config, "en") + [400, 500, 600]] * 2)
    maps = TW.cross_attention_weights(model, tokens, enc.to(torch.bfloat16))
    assert maps.dtype == torch.float32 and maps.shape == (2, 2, config.n_text_head, 7, 50)
    assert torch.isfinite(maps).all()
    np.testing.assert_allclose(maps.sum(-1).numpy(), 1.0, atol=1e-5)


# -- the engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    port, ref = TE.WhisperEngine("test", **ENGINE_KW), JE.WhisperEngine("test", **ENGINE_KW)
    yield port, ref
    port.close()
    ref.close()


def assert_words_equal(t_outs, j_outs):
    for t, j in zip(t_outs, j_outs):
        assert [w[2] for w in t.words] == [w[2] for w in j.words]
        np.testing.assert_allclose(np.array([w[:2] for w in t.words]).reshape(-1, 2),
                                   np.array([w[:2] for w in j.words]).reshape(-1, 2),
                                   atol=1e-6, err_msg=f"port {t.words}\njax  {j.words}")
        assert [(s.start, s.end, s.text) for s in t.segments] == \
            [(s.start, s.end, s.text) for s in j.segments]


WORD_CASES = {
    "greedy": {},
    "beam5": {"beam_size": 5},
    "timestamps": {"without_timestamps": False},
}


@pytest.mark.parametrize("case", sorted(WORD_CASES))
def test_engine_words_equal_the_jax_engine(engines, case):
    port, ref = engines
    options = {**NO_SILENCE, **WORD_CASES[case]}
    group = [(1.2, "en", 1), (1.9, None, 2), (0.7, "en", 3)]
    outs = []
    for module, eng in ((TE, port), (JE, ref)):
        tasks = [module._Task(module.DecodeRequest(_audio(s, seed), language=lang,
                                                   options=dict(options)), None)
                 for s, lang, seed in group]
        outs.append(eng._harvest(eng._device_phase(tasks)))
    t_out, j_out = outs
    assert any(o.words for o in t_out), "no row gave words"
    assert_words_equal(t_out, j_out)
    for o, (seconds, _, _) in zip(t_out, group):
        starts = [w[0] for w in o.words]
        assert starts == sorted(starts)
        assert all(0.0 <= ws <= we <= seconds + 1e-6 for ws, we, _ in o.words)
        if o.words and case != "timestamps":
            # the one segment narrowed to its words' extent
            assert o.segments[0].start == o.words[0][0]


def test_engine_words_off_give_none(engines):
    port, _ = engines
    out = port.transcribe_sync(TE.DecodeRequest(_audio(1.2, 1), language="en",
                                                options={"no_speech_threshold": None}))
    assert out.words == []


def test_long_final_words_equal_the_jax_engine(engines):
    """The seek loop shifts each window's words by its offset
    (``tests/test_word_timestamps.py:96``), as the JAX engine does."""
    port, ref = engines
    audio = _audio(3.5, 6)
    outs = [eng.transcribe_sync(module.DecodeRequest(audio, language="en", is_final=True,
                                                     options=dict(NO_SILENCE)))
            for module, eng in ((TE, port), (JE, ref))]
    t_out, j_out = outs
    assert t_out.words and max(w[0] for w in t_out.words) >= 2.0, t_out.words
    assert_words_equal([t_out], [j_out])
    starts = [w[0] for w in t_out.words]
    assert starts == sorted(starts)
    assert all(0.0 <= ws <= we <= 3.5 + 1e-6 for ws, we, _ in t_out.words)


def test_failed_alignment_leaves_no_words(engines, monkeypatch, caplog):
    port, _ = engines

    def boom(*args, **kwargs):
        raise RuntimeError("alignment broke")

    monkeypatch.setattr(TW, "cross_attention_weights", boom)
    out = port.transcribe_sync(TE.DecodeRequest(_audio(1.2, 1), language="en",
                                                options=dict(NO_SILENCE)))
    assert out.segments and out.words == []
    assert "word-timestamp alignment failed" in caplog.text
