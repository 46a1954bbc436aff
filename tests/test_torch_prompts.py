"""Conditioning prompts, forced prefixes and clip ranges in the port against
the JAX package.

The port's engine builds the JAX engine's prompt for every option
(``[sot_prev] + initial_prompt/hotwords`` truncated to ``n_text_ctx // 2 -
1`` tokens, a server-injected ``_cond_ctx`` context bucketed down to 8, 16,
32, 64 or 128 tokens, the ``prefix`` tokens after the sot sequence), parses
``clip_timestamps`` as it does, and serves them: on the CPU in float32 the
outputs of ``WhisperEngine("test", device="cpu", compute_type="float32")``
equal the JAX engine's (text, segments to 1e-6, ``avg_logprob`` within 1e-5,
language), with fixed and auto-detected languages, greedy and beam 5, with a
repetition penalty and n-gram bans beside them (``tests/test_engine.py:196,
352, 890, 903, 1169``). Two edges: a prompt whose width plus the decode
passes the 448 positions of the text context (the position table's last
row is read past it, as JAX's index clamps), at the model level and through
the engine (a full user prompt and a long prefix); and the drafted decode of
streaming partials
with a conditioning prompt, which gives the plain decode's (and so the JAX
engine's) outputs.
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
from tests.test_torch_timestamps import ENGINE_KW, MAX_NEW, _audio, assert_outputs_equal
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CFG = JW.PRESETS["test"]
LAYOUT = JW.token_layout(CFG.n_vocab)
LONG_TEXT = " ".join(f"word{i}" for i in range(300))


@pytest.fixture(scope="module")
def engines():
    port, ref = TE.WhisperEngine("test", **ENGINE_KW), JE.WhisperEngine("test", **ENGINE_KW)
    yield port, ref
    port.close()
    ref.close()


PROMPT_OPTIONS = [
    {}, {"initial_prompt": "Hello context"}, {"hotwords": "alpha beta"},
    {"initial_prompt": "  "}, {"initial_prompt": LONG_TEXT},
    {"prefix": "Hello world"}, {"prefix": LONG_TEXT},
    {"initial_prompt": "one two three", "prefix": "four", "without_timestamps": False},
    {"initial_prompt": "one two three", "_cond_ctx": True},
    {"initial_prompt": " ".join(["w"] * 20), "_cond_ctx": True},
    {"initial_prompt": " ".join(["w"] * 90), "_cond_ctx": True},
    {"initial_prompt": LONG_TEXT, "_cond_ctx": True},
]


@pytest.mark.parametrize("options", PROMPT_OPTIONS)
def test_prompt_parts_equal_the_reference(engines, options):
    """``tests/test_engine.py:196``: the conditioning prompt leads with
    sot_prev; every prompt, and its group key's lengths, are the JAX
    engine's."""
    port, ref = engines
    for lang in ("en", None):
        t_req = TE.DecodeRequest(np.zeros(100, np.float32), language=lang, options=options)
        j_req = JE.DecodeRequest(np.zeros(100, np.float32), language=lang, options=options)
        assert port._prompt_parts(t_req) == tuple(ref._prompt_parts(j_req))
        t_key, j_key = port._group_key(TE._Task(t_req, None)), ref._group_key(JE._Task(j_req, None))
        assert t_key[:5] == j_key[:5]
    ctx = port._prompt_parts(t_req)[0]
    assert not ctx or (ctx[0] == LAYOUT.sot_prev and len(ctx) <= CFG.n_text_ctx // 2)


@pytest.mark.parametrize("raw", ["0", None, "1,2,3,4", [2.5], "bogus", [], [0.0], "0.5,",
                                 (1, 2)])
def test_clip_ranges_parse_as_the_reference(raw):
    """``tests/test_engine.py:1169`` on the port, and the zeroed audio."""
    t_req = TE.DecodeRequest(np.zeros(10, np.float32), options={"clip_timestamps": raw})
    j_req = JE.DecodeRequest(np.zeros(10, np.float32), options={"clip_timestamps": raw})
    assert TE._clip_ranges_of(t_req) == JE._clip_ranges_of(j_req)
    clips = TE._clip_ranges_of(t_req)
    if clips is not None:
        audio = _audio(5.0, 4)
        np.testing.assert_array_equal(TE._apply_clips(audio, clips),
                                      JE._apply_clips(audio, clips))


SERVED = {
    "hotwords-beam": {"hotwords": "alpha beta gamma", "beam_size": 5},
    "cond-ctx": {"initial_prompt": " ".join(["w"] * 40), "_cond_ctx": True},
    "prefix": {"prefix": "Hello world"},
    "clip": {"clip_timestamps": "0.2,0.9"},
    "penalty-ngram": {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3,
                      "initial_prompt": "one two"},
    "penalty-ngram-beam": {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3,
                           "beam_size": 5},
}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_served_options_equal_the_jax_engine(engines, case):
    port, ref = engines
    options = SERVED[case]
    group = [(1.2, "en", 1), (1.9, None, 2), (0.7, "de", 3)]
    outs = []
    for module, eng in ((TE, port), (JE, ref)):
        tasks = [module._Task(module.DecodeRequest(_audio(s, seed), language=lang,
                                                   options=dict(options)), None)
                 for s, lang, seed in group]
        ctx = eng._device_phase(tasks)
        # ``tests/test_engine.py:352``: the prompt reaches the decoded array
        assert list(ctx["prompt_arr"][0]) == eng._prompt_for(tasks[0].request)
        outs.append(eng._harvest(ctx))
    assert_outputs_equal(*outs)
    if "prefix" in options:
        # ``tests/test_engine.py:890``: the prefix text leads the transcript
        for out in outs[0]:
            assert " ".join(s.text for s in out.segments).strip().startswith("Hello world")


def test_clip_timestamps_masks_audio(engines):
    """``tests/test_engine.py:903`` on the port: a clip over the whole
    window decodes as the unclipped request."""
    port, _ = engines
    full = port.transcribe_sync(TE.DecodeRequest(_audio(0.8, 17), language="en"))
    clipped = port.transcribe_sync(TE.DecodeRequest(_audio(0.8, 17), language="en",
                                                    options={"clip_timestamps": "0,999"}))
    assert [s.text for s in full.segments] == [s.text for s in clipped.segments]


def test_prompts_past_the_text_context_match_jax():
    """A 445-token prompt and 8 new tokens: positions 448..452 read the
    position table's last row, as the JAX package's clamped index does."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    model, jparams = TW.build_model(config, params, torch.device("cpu")), jax.tree.map(
        jnp.asarray, params)
    rng = np.random.default_rng(8)
    mel = rng.normal(0, 1, (2, config.n_mels, 200)).astype(np.float32)
    enc = model.encoder(torch.from_numpy(mel)).detach()
    ctx = [LAYOUT.sot_prev] + rng.integers(1000, 20000, 440).tolist()
    prompt = torch.tensor([ctx + TW.build_prompt(model.config, "en")] * 2)
    plen = torch.full((2,), prompt.shape[1])
    got = TW.greedy_decode(model, enc, prompt, plen, 8, sot_pos=len(ctx))
    ref = JW.greedy_decode(jparams, jnp.asarray(enc.numpy()), jnp.asarray(prompt.numpy()),
                           jnp.asarray(plen.numpy()), None, CFG, CFG.n_text_head, 8,
                           sot_pos=jnp.int32(len(ctx)))
    assert int(got.lengths.max()) > CFG.n_text_ctx
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               rtol=1e-5)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-5)


def _words(tokenizer, n_tokens: int) -> str:
    """Words whose encoding (with its leading space) reaches ``n_tokens``."""
    words = []
    while len(tokenizer.encode(" " + " ".join(words))) < n_tokens:
        words.append(f"word{len(words)}")
    return " ".join(words)


def test_engine_prompt_past_the_text_context_equals_the_jax_engine(engines):
    """Through the engines: a user prompt of the whole 223-token budget and
    a prefix of ~212 tokens, so the prompt ends just short of 448 and its
    16 new tokens pass it."""
    port, ref = engines
    options = {"initial_prompt": LONG_TEXT, "prefix": _words(port.tokenizer, 212)}
    outs = [eng.transcribe_sync(module.DecodeRequest(_audio(1.5, 5), language="en",
                                                     options=options))
            for module, eng in ((TE, port), (JE, ref))]
    assert outs[0]._p_len <= CFG.n_text_ctx < outs[0]._p_len + MAX_NEW
    assert_outputs_equal([outs[0]], [outs[1]])


def test_drafted_partials_take_a_conditioning_prompt(engines):
    """A session's partials under ``draft_mode="on"`` with the streaming
    conditioning prompt: the second verifies the first's tokens on the
    drafted entry at the conditioned prompt width, and both equal the plain
    decode (the JAX engine's outputs)."""
    _, ref = engines
    port = TE.WhisperEngine("test", draft_mode="on", **ENGINE_KW)
    options = {"initial_prompt": " ".join(["w"] * 40), "_cond_ctx": True}
    outs = []
    for seconds in (1.2, 1.6):
        req = dict(language="en", options=dict(options), session_id="s1")
        got = port.transcribe_sync(TE.DecodeRequest(_audio(seconds, 6), **req))
        want = ref.transcribe_sync(JE.DecodeRequest(_audio(seconds, 6), **req))
        outs.append((got, want))
    assert port.draft_stats["rows"] == 1 and port.draft_stats["offered"] > 0
    p_len = len(port._prompt_for(TE.DecodeRequest(_audio(1.2, 6), options=options)))
    assert p_len > 4 and port.graphs.lookup(2.0, 1, p_len, MAX_NEW, drafted=True)
    for got, want in outs:
        assert_outputs_equal([got], [want])
    port.close()
