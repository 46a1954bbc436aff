"""Timestamps in the port against the JAX package.

Model level, on the CPU in float32: the JAX model tests
(``tests/test_whisper_model.py:248, 278, 303, 337, 412``) run on the port's
``greedy_decode_timestamps``, ``beam_decode(with_timestamps=True)``
(frozen-slot and pooled) and ``split_timestamp_segments``, and each decode's
tokens and lengths are held equal to the JAX function's (logprob sums within
atol 1e-5 plus rtol 1e-6), on the ``test`` preset's random weights with the
timestamp prompt ``[sot, lang, task]`` and on the eot-prone weights of
``tests/test_torch_beam.py`` (rows that finish at different steps). The
grammar's logit rules are held against ``_ts_apply`` on random logits and
random grammar states.

Engine level: timestamp requests (greedy, beam 5, pooled beam) served by
both ``WhisperEngine("test", device="cpu", compute_type="float32")`` give
equal segments (text, start and end within 1e-6), ``avg_logprob`` within
1e-5 and language; the group key keeps the beam with timestamps on
(``tests/test_engine.py:176, 944``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.engine import engine as JE
from stt_tpu.models import whisper as JW
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_beam import _eot_prone
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CFG = JW.PRESETS["test"]
LAYOUT = JW.token_layout(CFG.n_vocab)
TS_BEGIN = LAYOUT.timestamp_begin
SUM_ATOL, SUM_RTOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    """``tests/test_whisper_model.py::_ts_setup`` for both packages: seed-21
    weights, two rows of encoder output, the timestamp prompt."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=21)
    model = TW.build_model(config, params, torch.device("cpu"))
    rng = np.random.default_rng(21)
    mel = rng.normal(0, 1, (2, config.n_mels, 100)).astype(np.float32)
    enc = model.encoder(torch.from_numpy(mel)).detach()
    prompt = torch.tensor(np.tile([LAYOUT.sot, LAYOUT.lang_begin, LAYOUT.transcribe], (2, 1)))
    return model, jax.tree.map(jnp.asarray, params), enc, prompt


def _jnp(x):
    return jnp.asarray(np.asarray(x), jnp.int32)


def _decode_both(model, jparams, enc, prompt, max_new, beam=1, patience=1.0):
    plen = torch.full((prompt.shape[0],), prompt.shape[1])
    enc_j = jnp.asarray(enc.numpy())
    if beam == 1:
        got = TW.greedy_decode_timestamps(model, enc, prompt, plen, max_new)
        ref = JW.greedy_decode_timestamps(jparams, enc_j, _jnp(prompt), _jnp(plen), None, CFG,
                                          CFG.n_text_head, max_new)
    else:
        got = TW.beam_decode(model, enc, prompt, plen, max_new, beam_size=beam,
                             patience=patience, with_timestamps=True)
        ref = JW.beam_decode(jparams, enc_j, _jnp(prompt), _jnp(plen), None, CFG,
                             CFG.n_text_head, max_new, beam_size=beam, patience=patience,
                             with_timestamps=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=SUM_ATOL, rtol=SUM_RTOL)
    return got


def _generated(res, row, p_len=3):
    return [int(t) for t in res.tokens[row, p_len:int(res.lengths[row])]]


def _assert_grammar(gen, lone_initial=True):
    assert gen, "no tokens generated"
    assert TS_BEGIN <= gen[0] <= TS_BEGIN + TW.MAX_INITIAL_TIMESTAMP
    stamps = [t for t in gen if t >= TS_BEGIN]
    assert stamps == sorted(stamps)
    run = 0
    for t in gen:
        run = run + 1 if t >= TS_BEGIN else 0
        assert run <= 2
    if lone_initial and len(gen) > 1:
        assert gen[1] < TS_BEGIN


@pytest.fixture(scope="module")
def greedy_ts(setup):
    """The greedy timestamp decode of :func:`setup`, held to JAX's once."""
    return _decode_both(*setup, 30)


def test_timestamp_decode_obeys_grammar(greedy_ts):
    """``tests/test_whisper_model.py:248``: the first token a timestamp
    within the initial cap, timestamps never decrease, never three in a
    row; the JAX package's tokens."""
    res = greedy_ts
    for row in range(2):
        _assert_grammar(_generated(res, row), lone_initial=False)


def test_timestamp_initial_lone_ts_followed_by_text(greedy_ts):
    """``:278``: a lone initial timestamp is followed by text or eot."""
    res = greedy_ts
    for row in range(2):
        gen = _generated(res, row)
        assert gen[0] >= TS_BEGIN
        if len(gen) > 1:
            assert gen[1] < TS_BEGIN


def test_beam_timestamp_grammar(setup):
    """``:303``: beam search keeps the grammar (and the JAX tokens)."""
    res = _decode_both(*setup, 30, beam=2)
    for row in range(2):
        _assert_grammar(_generated(res, row))


def test_beam_pooled_timestamp_grammar():
    """``:337``: the pooled search (patience 2) keeps it too, on seed 23."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=23)
    model = TW.build_model(config, params, torch.device("cpu"))
    mel = np.random.default_rng(23).normal(0, 1, (2, config.n_mels, 100)).astype(np.float32)
    enc = model.encoder(torch.from_numpy(mel)).detach()
    prompt = torch.tensor(np.tile([LAYOUT.sot, LAYOUT.lang_begin, LAYOUT.transcribe], (2, 1)))
    res = _decode_both(model, jax.tree.map(jnp.asarray, params), enc, prompt, 30, beam=2,
                       patience=2.0)
    for row in range(2):
        _assert_grammar(_generated(res, row), lone_initial=False)


@pytest.fixture(scope="module")
def eot_prone():
    model, jparams, enc, _ = _eot_prone("test")
    prompt = torch.tensor(np.tile(TW.build_prompt(model.config, "en", without_timestamps=False),
                                  (3, 1)))
    return model, jparams, enc, prompt


@pytest.mark.parametrize("beam,patience", [(1, 1.0), (2, 1.0), (5, 1.0), (2, 2.0)])
def test_timestamp_decodes_that_finish_early_match_jax(eot_prone, beam, patience):
    """Rows that end at different steps, greedy and beam, frozen and pooled."""
    res = _decode_both(*eot_prone, 24, beam=beam, patience=patience)
    assert (res.lengths < 3 + 24).any()


def test_split_timestamp_segments():
    """``:412`` on the port's copy."""
    seq = [TS_BEGIN + 0, 10, 11, TS_BEGIN + 50, TS_BEGIN + 50, 12, TS_BEGIN + 100, LAYOUT.eot]
    assert TW.split_timestamp_segments(seq, CFG, duration=5.0) == [
        (0.0, 1.0, [10, 11]), (1.0, 2.0, [12])]
    assert TW.split_timestamp_segments([TS_BEGIN, 10, LAYOUT.eot], CFG, 3.0) == [
        (0.0, 3.0, [10])]
    assert TW.split_timestamp_segments([10, 11, LAYOUT.eot], CFG, 2.0) == [(0.0, 2.0, [10, 11])]
    for seq in ([TS_BEGIN + 3, 9, TS_BEGIN + 7, 5, 6], [TS_BEGIN, TS_BEGIN + 1, 4, LAYOUT.eot]):
        assert (TW.split_timestamp_segments(seq, CFG, 4.0)
                == JW.split_timestamp_segments(seq, CFG, 4.0))


@pytest.mark.parametrize("seed", range(4))
def test_ts_rules_equal_jax(seed):
    """The grammar's logits on random logits and states (rows of 3 x 2,
    each state flag and generated count), the sum-probability rule tipping
    some rows."""
    rng = np.random.default_rng(seed)
    v = CFG.n_vocab
    logits = rng.normal(0, 3, (3, 2, v)).astype(np.float32)
    logits[..., TS_BEGIN:] += rng.normal(0, 4, (3, 2, 1)).astype(np.float32)
    last_ts = rng.integers(TS_BEGIN - 1, TS_BEGIN + 60, (3, 2))
    last_was = rng.random((3, 2)) < 0.5
    penult = rng.random((3, 2)) < 0.5
    rules = TW.init_rules(TW.get_config("test"), (3, 2), TW.Route(timestamps=True),
                          torch.device("cpu"))
    rules.last_ts.copy_(torch.from_numpy(last_ts))
    rules.last_was_ts.copy_(torch.from_numpy(last_was))
    rules.penult_was_ts.copy_(torch.from_numpy(penult))
    for gen_count in (0, 1, 5):
        got = TW._ts_apply(rules, torch.from_numpy(logits), torch.tensor(gen_count))
        ref = JW._ts_apply(JW._ts_rules(CFG, TW.MAX_INITIAL_TIMESTAMP), jnp.asarray(logits),
                           _jnp(last_ts), jnp.asarray(last_was), jnp.asarray(penult),
                           gen_count=jnp.int32(gen_count))
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
        np.testing.assert_allclose(np.where(np.isinf(ref), 0, got.numpy()),
                                   np.where(np.isinf(ref), 0, ref), atol=1e-6)


# -- the engine ---------------------------------------------------------------------


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


# 16 new tokens in each bucket (max_new_for's floor of 24 capped at the bound)
ENGINE_KW = dict(device="cpu", compute_type="float32", audio_buckets_sec=(1.0, 2.0),
                 batch_buckets=(1, 4), max_decode_tokens=16)
MAX_NEW = 16
ENGINE_CASES = {
    "greedy": {"without_timestamps": False},
    "beam5": {"without_timestamps": False, "beam_size": 5},
    "pooled": {"without_timestamps": False, "beam_size": 2, "patience": 2.0},
    "greedy-penalty-ignored": {"without_timestamps": False, "repetition_penalty": 1.5,
                               "no_repeat_ngram_size": 2, "suppress_blank": False},
}


@pytest.fixture(scope="module")
def engines():
    port, ref = TE.WhisperEngine("test", **ENGINE_KW), JE.WhisperEngine("test", **ENGINE_KW)
    yield port, ref
    port.close()
    ref.close()


def _serve_both(engines, group, options):
    port, ref = engines
    outs = []
    for module, eng in ((TE, port), (JE, ref)):
        tasks = [module._Task(module.DecodeRequest(_audio(s, seed), language=lang,
                                                   options=dict(options)), None)
                 for s, lang, seed in group]
        outs.append(eng._harvest(eng._device_phase(tasks)))
    return outs


def assert_outputs_equal(t_out, j_out):
    """Segments (text, start and end within 1e-6), avg_logprob within 1e-5,
    language, the ladder rung's temperature and the generated count."""
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert [s.text for s in t.segments] == [s.text for s in j.segments]
        np.testing.assert_allclose(np.array([(s.start, s.end) for s in t.segments]).reshape(-1, 2),
                                   np.array([(s.start, s.end) for s in j.segments]).reshape(-1, 2),
                                   atol=1e-6)
        assert t.avg_logprob == pytest.approx(j.avg_logprob, abs=1e-5)
        assert t.no_speech_prob == pytest.approx(j.no_speech_prob, rel=1e-5)
        assert t.info.language == j.info.language
        assert t.temperature_used == j.temperature_used
        assert t._n_gen == j._n_gen


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_timestamp_requests_equal_the_jax_engine(engines, case):
    """``tests/test_engine.py:176``: timestamp segments in range and
    ordered; every output the JAX engine's, auto-detected rows included."""
    group = [(1.2, "en", 1), (1.9, None, 2), (0.7, "en", 3)]
    t_out, j_out = _serve_both(engines, group, ENGINE_CASES[case])
    assert_outputs_equal(t_out, j_out)
    for out, (seconds, _, _) in zip(t_out, group):
        starts = [s.start for s in out.segments]
        assert starts == sorted(starts)
        for seg in out.segments:
            assert 0.0 <= seg.start <= seg.end <= seconds + 1e-6
    assert any(len(o.segments) > 1 for o in t_out) or any(o.segments for o in t_out)


def test_accurate_with_timestamps_keeps_beam(engines):
    """``tests/test_engine.py:944``: the group key keeps beam 5 with
    timestamps on, and the decode completes on a beam timestamp entry."""
    port, _ = engines
    opts = {"beam_size": 5, "without_timestamps": False}
    key = port._group_key(TE._Task(TE.DecodeRequest(_audio(0.8, 31), language="en",
                                                    options=opts), None))
    assert key[3] == 5 and key[4] is True
    out = port.transcribe_sync(TE.DecodeRequest(_audio(0.8, 31), language="en", options=opts))
    for seg in out.segments:
        assert 0.0 <= seg.start <= seg.end <= 0.8 + 1e-6
    assert port.graphs.lookup(1.0, 1, 3, MAX_NEW, beam=5, route=TW.Route(timestamps=True))
