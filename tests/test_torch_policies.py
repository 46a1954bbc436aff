"""The port's decoder policies against the JAX package's, on identical weights.

The four opt-in switches of ``stt_tpu/models/whisper.py`` are module
globals there, set here with ``monkeypatch.setattr`` as
``tests/test_quant_weights.py`` sets them; the port carries them as a
frozen :class:`~stt_tpu_torch.models.whisper.DecoderPolicy` of its model.

- int8 decoder weights (``STT_DECODER_WEIGHTS_DTYPE=int8``): the port
  quantises the model's bfloat16 weights itself at load; its codes and
  scales are held to ``quantize_decoder_weights``'s on the ``tiny`` preset:
  scales equal, codes equal but for at most one code where the two float32
  quotients straddle a rounding edge (none was seen on these weights; the
  bound allows a share of 1e-5), the dequantisation bound |w - q s| <= s/2.
- fused q/k/v and the sequential prefill change no arithmetic in float32:
  greedy, beam and drafted decodes of the ``test`` model give JAX's tokens
  and lengths exactly, and one decode step's logits after the prefill are
  within 1e-5 (p(no_speech) of the sequential prefill too).
- int8, int8_native and the fp8 self cache under bfloat16: one decode
  step's logits after a prefill are within 0.05 of JAX's under the same
  policy (the bfloat16 bound of ``tests/test_torch_whisper.py``).
- fused then int8: the fused projection's codes are the separate
  projections' codes side by side, and JAX's fused codes.
- every route (beam, timestamps, penalty and bans, the sampling ladder,
  word timestamps), a drafted tick and the seek loop of a long final serve
  under each policy on a bf16 ``test``-model engine.

The JAX decodes run through their unjitted bodies where a switch changes
nothing in the parameter tree (``tests/test_draft_decode.py`` does the same
for ``PREFILL``), so no cached trace outlives the switch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

F32_ATOL = 1e-5
BF16_LOGITS_ATOL = 0.05
MAX_NEW = 24
CODE_MISMATCH_SHARE = 1e-5
CPU = torch.device("cpu")

JAX_SWITCHES = {
    "int8": dict(DECODER_WEIGHTS_DTYPE="int8", _W8_NATIVE=False),
    "int8_native": dict(DECODER_WEIGHTS_DTYPE="int8_native", _W8_NATIVE=True),
    "fused": dict(FUSED_QKV="on"),
    "fp8": dict(SELF_KV_DTYPE="fp8"),
    "seq": dict(PREFILL="seq"),
    "fused_int8": dict(FUSED_QKV="on", DECODER_WEIGHTS_DTYPE="int8", _W8_NATIVE=False),
}
PORT_POLICY = {
    "int8": TW.DecoderPolicy(weights="int8"),
    "int8_native": TW.DecoderPolicy(weights="int8_native"),
    "fused": TW.DecoderPolicy(fused_qkv=True),
    "fp8": TW.DecoderPolicy(self_kv="fp8"),
    "seq": TW.DecoderPolicy(prefill="seq"),
    "fused_int8": TW.DecoderPolicy(weights="int8", fused_qkv=True),
}


def _jax_policy(monkeypatch, name):
    for attr, value in JAX_SWITCHES[name].items():
        monkeypatch.setattr(JW, attr, value)


def _jax_decoder(dec, dtype):
    """The JAX engine's load transforms, in its order (fuse, then quantise)."""
    return JW.quantize_decoder_weights(JW.fuse_decoder_qkv(dec), dtype)


def _pair(name, dtype, monkeypatch, preset="test"):
    """(port model, JAX params) of ``preset`` under policy ``name``."""
    config = TW.get_config(preset)
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, CPU, dtype, decoder_policy=PORT_POLICY[name])
    _jax_policy(monkeypatch, name)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = JW.init_params(JW.get_config(preset), seed=0, dtype=jdtype)
    jparams["decoder"] = _jax_decoder(jparams["decoder"], jdtype)
    return model, jparams


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- int8 codes and scales -------------------------------------------------------


def _port_linears(dec):
    """{(layer, path): Linear} of the decoder's quantisable linears."""
    out = {}
    for li, block in enumerate(dec.blocks):
        for part, mod in (("attn", block.attn), ("xattn", block.xattn)):
            for name in ("qkv", "q", "k", "v", "o"):
                lin = getattr(mod, name)
                if lin is not None:
                    out[(li, part, name)] = lin
        out[(li, "mlp", "fc1")] = block.mlp.fc1
        out[(li, "mlp", "fc2")] = block.mlp.fc2
    return out


def _codes_against_jax(model, jdec):
    """(mismatched codes, codes, largest code difference), asserting the
    scales equal."""
    bad = total = worst = 0
    for (li, part, name), lin in _port_linears(model.decoder).items():
        leaf = jdec["blocks"][part][name]
        jq = np.asarray(leaf["wq"])[li]                   # (d_in, d_out)
        np.testing.assert_array_equal(lin.ws.numpy(), np.asarray(leaf["ws"], np.float32)[li])
        diff = np.abs(lin.wq.t().numpy().astype(np.int32) - jq.astype(np.int32))
        bad, total, worst = bad + int((diff > 0).sum()), total + diff.size, max(worst, diff.max())
    dec = model.decoder
    vocab = dec.n_vocab
    np.testing.assert_array_equal(dec.tok_s.numpy(), np.asarray(jdec["tok"]["ws"], np.float32))
    diff = np.abs(dec.tok_q[:vocab].numpy().astype(np.int32)
                  - np.asarray(jdec["tok"]["wq"]).astype(np.int32))
    return bad + int((diff > 0).sum()), total + diff.size, max(worst, diff.max())


@pytest.mark.parametrize("name", ["int8", "int8_native", "fused_int8"])
def test_int8_codes_and_scales_match_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.bfloat16, monkeypatch, preset="tiny")
    bad, total, worst = _codes_against_jax(model, jparams["decoder"])
    print(f"{name}: {bad} of {total} codes differ from JAX's (share {bad / total:.2e})")
    assert worst <= 1 and bad / total <= CODE_MISMATCH_SHARE


def test_int8_storage_structure_and_dequant_bound():
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, CPU, torch.bfloat16,
                           decoder_policy=TW.DecoderPolicy(weights="int8_native"))
    dec = model.decoder
    assert dec.tok is None and dec.tok_q.dtype == torch.int8
    assert dec.tok_q.shape == (-(-config.n_vocab // 8) * 8, config.n_text_state)
    assert not dec.tok_q[config.n_vocab:].any()            # the native padding rows
    lin = dec.blocks[0].attn.q
    assert lin.w is None and lin.wq.dtype == torch.int8 and lin.native
    assert lin.wq.shape == (config.n_text_state, config.n_text_state)
    assert lin.b.dtype == torch.bfloat16 and dec.blocks[0].ln1.g.dtype == torch.bfloat16
    w = torch.from_numpy(params["decoder"]["blocks"]["attn"]["q"]["w"][0]).to(torch.bfloat16)
    deq = lin.wq.t().float() * lin.ws
    assert ((w.float() - deq).abs() <= lin.ws / 2 + 1e-8).all()
    # the encoder keeps its weights
    assert model.encoder.blocks[0].attn.q.wq is None


def test_int8_under_float32_compute_keeps_the_weights():
    config = TW.get_config("test")
    model = TW.build_model(config, TW.init_params(config, seed=0), CPU, torch.float32,
                           decoder_policy=TW.DecoderPolicy(weights="int8"))
    assert model.decoder.tok_q is None and model.decoder.blocks[0].attn.q.wq is None


def test_fused_then_int8_equals_int8_of_the_fused_weights(monkeypatch):
    model, jparams = _pair("fused_int8", torch.bfloat16, monkeypatch)
    sep = TW.build_model(model.config, TW.init_params(model.config, seed=0), CPU, torch.bfloat16,
                         decoder_policy=PORT_POLICY["int8"])
    for fused, plain in zip(model.decoder.blocks, sep.decoder.blocks):
        qkv = fused.attn.qkv
        assert torch.equal(qkv.wq, torch.cat([plain.attn.q.wq, plain.attn.k.wq,
                                              plain.attn.v.wq], dim=0))
        assert torch.equal(qkv.ws, torch.cat([plain.attn.q.ws, plain.attn.k.ws,
                                              plain.attn.v.ws]))
    bad, _, worst = _codes_against_jax(model, jparams["decoder"])
    assert worst <= 1


# -- float32: fused and seq change no arithmetic ----------------------------------


def _inputs(config, batch=3, seed=11):
    jparams = JW.init_params(JW.get_config(config.name), seed=0)
    mel = np.random.default_rng(seed).normal(0, 1, (batch, config.n_mels, 200)).astype(np.float32)
    enc = np.array(JW.encode(jparams, jnp.asarray(mel), config.n_audio_head))
    prompt = np.tile(np.array(TW.build_prompt(config, "en"), np.int32), (batch, 1))
    return enc, prompt


def _step_pair(model, jparams, enc, prompt):
    """(port, JAX): (p(no_speech), logits of the step at the last prompt
    position), both after their prefill of the prompt."""
    config = model.config
    b, p_len = prompt.shape
    layout = TW.token_layout(config.n_vocab)
    jcfg = JW.get_config(config.name)
    jenc = jnp.asarray(enc, jnp.bfloat16 if model.decoder.pos.dtype == torch.bfloat16
                       else jnp.float32)
    jckv = JW.precompute_cross_kv(jparams, jenc, config.n_text_head)
    jcache = JW.init_kv_cache(jcfg, b, p_len + 4, dtype=jenc.dtype)
    jcache, jns = JW._prefill(jparams, jnp.asarray(prompt), p_len, jcache, jckv,
                              config.n_text_head, 0, JW.token_layout(config.n_vocab))
    jlogits, _ = JW._decoder_step(jparams, jnp.asarray(prompt[:, -1]), p_len - 1, jcache, jckv,
                                  config.n_text_head, p_len - 1)
    dec = model.decoder
    tenc = torch.from_numpy(_np(jenc)).to(dec.pos.dtype)
    ckv = TW.precompute_cross_kv(dec, tenc)
    cache = TW.init_kv_cache(config, b, p_len + 4, dec.decoder_policy.cache_dtype(tenc.dtype), CPU)
    tokens = torch.from_numpy(prompt.astype(np.int64))
    ns = TW._prefill(dec, tokens, p_len, cache, ckv, 0, layout)
    logits = TW._decoder_step(dec, tokens[:, -1], p_len - 1, cache, ckv)
    return (ns.float().numpy(), logits.float().numpy()), (_np(jns), _np(jlogits))


@pytest.mark.parametrize("name", ["fused", "seq"])
def test_float32_step_logits_match_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.float32, monkeypatch)
    enc, prompt = _inputs(model.config)
    (ns, logits), (jns, jlogits) = _step_pair(model, jparams, enc, prompt)
    np.testing.assert_allclose(logits, jlogits, atol=F32_ATOL)
    np.testing.assert_allclose(ns, jns, atol=F32_ATOL)


@pytest.mark.parametrize("name", ["fused", "seq"])
def test_float32_greedy_tokens_equal_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.float32, monkeypatch)
    config = model.config
    enc, prompt = _inputs(config)
    plen = np.full((len(prompt),), prompt.shape[1], np.int32)
    ref = JW.greedy_decode.__wrapped__(jparams, jnp.asarray(enc), jnp.asarray(prompt),
                                       jnp.asarray(plen), None, JW.get_config(config.name),
                                       config.n_text_head, max_new_tokens=MAX_NEW)
    got = TW.greedy_decode(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                           torch.from_numpy(plen).long(), MAX_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               atol=F32_ATOL)


@pytest.mark.parametrize("name", ["fused", "seq"])
def test_float32_beam_tokens_equal_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.float32, monkeypatch)
    config = model.config
    enc, prompt = _inputs(config, batch=2, seed=12)
    plen = np.full((len(prompt),), prompt.shape[1], np.int32)
    ref = JW.beam_decode.__wrapped__(jparams, jnp.asarray(enc), jnp.asarray(prompt),
                                     jnp.asarray(plen), None, JW.get_config(config.name),
                                     config.n_text_head, MAX_NEW, beam_size=3)
    got = TW.beam_decode(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                         torch.from_numpy(plen).long(), MAX_NEW, beam_size=3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.mark.parametrize("name", ["fused", "seq"])
def test_float32_drafted_tokens_equal_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.float32, monkeypatch)
    config = model.config
    enc, prompt = _inputs(config, batch=3, seed=13)
    b, p_len = prompt.shape
    plen = np.full((b,), p_len, np.int32)
    plain = TW.greedy_decode(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                             torch.from_numpy(plen).long(), MAX_NEW)
    gen = plain.tokens[:, p_len:].numpy()
    draft = gen.copy()
    draft[1, 3:] = (draft[1, 3:] + 7) % 1000                  # a mid-draft mutation
    draft[2] = TW.token_layout(config.n_vocab).eot            # an empty draft
    dlen = np.array([MAX_NEW, MAX_NEW, 0], np.int64)
    ref = JW.greedy_decode_drafted.__wrapped__(
        jparams, jnp.asarray(enc), jnp.asarray(prompt), jnp.asarray(plen),
        jnp.asarray(draft, jnp.int32), jnp.asarray(dlen, jnp.int32),
        JW.get_config(config.name), config.n_text_head, MAX_NEW)
    got = TW.greedy_decode_drafted(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                                   torch.from_numpy(plen).long(), torch.from_numpy(draft),
                                   torch.from_numpy(dlen), MAX_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())


# -- bfloat16: the storage policies --------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "int8_native", "fp8", "fused_int8"])
def test_bf16_step_logits_close_to_jax(monkeypatch, name):
    model, jparams = _pair(name, torch.bfloat16, monkeypatch)
    rng = np.random.default_rng(1)
    enc = np.asarray(jnp.asarray(rng.normal(0, 1, (2, 12, model.config.n_text_state)),
                                 jnp.bfloat16).astype(jnp.float32))
    prompt = np.tile(np.array(TW.build_prompt(model.config, "en"), np.int32), (2, 1))
    (ns, logits), (jns, jlogits) = _step_pair(model, jparams, enc, prompt)
    assert np.abs(logits - jlogits).max() < BF16_LOGITS_ATOL
    assert np.abs(ns - jns).max() < BF16_LOGITS_ATOL


def test_fp8_cache_holds_fp8_and_round_trips():
    config = TW.get_config("test")
    model = TW.build_model(config, TW.init_params(config, seed=0), CPU, torch.bfloat16,
                           decoder_policy=PORT_POLICY["fp8"])
    enc = torch.randn(2, 12, config.n_text_state).to(torch.bfloat16)
    prompt = torch.tensor(np.tile(TW.build_prompt(config, "en"), (2, 1)))
    res = TW.greedy_decode(model, enc, prompt, torch.full((2,), 4), 10)
    assert res.tokens.shape == (2, 14)
    state = TW.init_decode_state(config, 2, 4, 10,
                                 model.decoder.decoder_policy.cache_dtype(torch.bfloat16), CPU)
    assert state.cache.k.dtype == torch.float8_e4m3fn


@pytest.mark.parametrize("dtype,expect", [
    (torch.bfloat16, TW.DecoderPolicy("int8_native", True, "fp8", "seq")),
    (torch.float32, TW.DecoderPolicy("bf16", True, "bf16", "seq")),
])
def test_policy_parses_as_the_reference(monkeypatch, dtype, expect):
    for var, value in (("STT_DECODER_WEIGHTS_DTYPE", " I8N "), ("STT_FUSED_QKV", "Yes"),
                       ("STT_SELF_KV_DTYPE", "float8"), ("STT_PREFILL", "SEQ")):
        monkeypatch.setenv(var, value)
    assert TW.DecoderPolicy.from_env(dtype) == expect
    monkeypatch.setenv("STT_PREFILL", "parallel")
    assert TW.DecoderPolicy.from_env(dtype).prefill == "parallel"


# -- every decode mode under every policy ------------------------------------------


def _tone(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(0, 1, t.shape)).astype(
        np.float32)


ROUTES = {
    "greedy": {}, "beam": {"beam_size": 3}, "timestamps": {"without_timestamps": False},
    "penalised": {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3},
    "ladder": {"temperature": [0.0, 0.4], "log_prob_threshold": 0.0},
    "words": {"word_timestamps": True, "no_speech_threshold": None},
}


@pytest.mark.parametrize("name", list(PORT_POLICY))
def test_every_route_and_the_seek_loop_serve_under_each_policy(monkeypatch, name):
    """A bf16 ``test``-model engine built under each policy's switches
    serves every route, a drafted tick and a final longer than its largest
    bucket (the seek loop), each output well formed."""
    from stt_tpu_torch.engine import engine as TE

    for var, value in {"int8": {"STT_DECODER_WEIGHTS_DTYPE": "int8"},
                       "int8_native": {"STT_DECODER_WEIGHTS_DTYPE": "int8_native"},
                       "fused": {"STT_FUSED_QKV": "on"}, "fp8": {"STT_SELF_KV_DTYPE": "fp8"},
                       "seq": {"STT_PREFILL": "seq"},
                       "fused_int8": {"STT_FUSED_QKV": "on",
                                      "STT_DECODER_WEIGHTS_DTYPE": "int8"}}[name].items():
        monkeypatch.setenv(var, value)
    engine = TE.WhisperEngine("test", device="cpu", compute_type="bfloat16", draft_mode="on",
                              audio_buckets_sec=(1.0, 2.0), batch_buckets=(1, 2),
                              max_decode_tokens=16)
    assert engine.decoder_policy == PORT_POLICY[name]
    try:
        for route, opts in ROUTES.items():
            out = engine.transcribe_sync(TE.DecodeRequest(_tone(1.5), language="en",
                                                          options=dict(opts)))
            assert 0 < out._n_gen <= 16 and np.isfinite(out.avg_logprob), route
        for tick in range(2):     # the second tick rides the drafted decode
            out = engine.transcribe_sync(TE.DecodeRequest(_tone(1.5, tick), language="en",
                                                          session_id="s"))
        assert engine.draft_stats["rows"] == 1 and 0 < out._n_gen <= 16
        long = engine.transcribe_sync(TE.DecodeRequest(_tone(5.0), language="en",
                                                       is_final=True))
        assert long.segments and long.segments[-1].end <= 5.0 + 1e-6
    finally:
        engine.close()
