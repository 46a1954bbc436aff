"""The port's fixed-shape decode step, chunked greedy loop, decode-graph
cache and prewarm, on the CPU.

The decode step has one shape at every position (``pos`` a 0-d tensor,
self-attention over every cache slot under the mask ``slot <= pos``), as the
JAX package's scalar-``pos`` ``_decoder_step``: both, on identical weights,
cache contents and cross K/V in float32, give logits and written caches
within 1e-5 at several positions (the two differ only in the order of
float32 sums). The greedy loop runs in chunks of ``FINISH_CHECK_EVERY``
steps on a preallocated state; looped, it gives exactly the tokens, lengths
and logprob sums of the per-step loop it replaces (kept below as the
reference, over the same step), including rows that finish in different
chunks, a group that stops early and bounds that are not a multiple of 8,
and JAX's tokens and lengths on the same weights. On the card the chunk is
captured as a CUDA graph (``tests/test_torch_kernels_cuda.py`` holds the
replay against the uncaptured chunk); here the same function runs
uncaptured.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stt_tpu.models import whisper as JW
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

STEP_ATOL = 1e-5


@pytest.fixture(scope="module", params=["test", "tiny"])
def pair(request):
    config = TW.get_config(request.param)
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, torch.device("cpu"))
    jparams = JW.init_params(JW.get_config(request.param), seed=0)
    mel = np.random.default_rng(11).normal(0, 1, (2, config.n_mels, 200)).astype(np.float32)
    enc = np.array(JW.encode(jparams, jnp.asarray(mel), config.n_audio_head))
    return config, model, jparams, enc


@pytest.mark.parametrize("pos", [0, 3, 6, 11, 15])
def test_fixed_shape_step_matches_jax(pair, pos):
    """One step at ``pos`` over a 16-slot cache whose every slot holds
    values (those past ``pos`` masked in both): logits and the cache after
    the write agree with the JAX step."""
    config, model, jparams, enc = pair
    b, t_max, h = 2, 16, config.n_text_head
    shape = (config.n_text_layer, b, h, t_max, config.n_text_state // h)
    rng = np.random.default_rng(100 + pos)
    k0, v0 = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, 50000, b)
    ref_logits, ref_cache = JW._decoder_step(
        jparams, jnp.asarray(tokens, jnp.int32), pos,
        JW.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
        JW.precompute_cross_kv(jparams, jnp.asarray(enc), h), h, pos,
    )
    cache = TW.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    ckv = TW.precompute_cross_kv(model.decoder, torch.from_numpy(enc))
    got = TW._decoder_step(model.decoder, torch.from_numpy(tokens),
                           torch.tensor(pos), cache, ckv)
    assert got.shape == (b, config.n_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_logits), atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref_cache.v), atol=STEP_ATOL, rtol=0)
    untouched = np.arange(t_max) != pos
    np.testing.assert_array_equal(cache.k.numpy()[..., untouched, :], k0[..., untouched, :])


def test_python_int_position_is_the_tensor_position(pair):
    config, model, _, enc = pair
    ckv = TW.precompute_cross_kv(model.decoder, torch.from_numpy(enc))
    tokens = torch.tensor([50258, 1000])
    outs = []
    for pos in (5, torch.tensor(5)):
        cache = TW.init_kv_cache(config, 2, 8, torch.float32, torch.device("cpu"))
        outs.append((TW._decoder_step(model.decoder, tokens, pos, cache, ckv), cache))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].k, outs[1][1].k)


def _per_step_greedy(model, enc, prompt, prompt_len, max_new):
    """The greedy loop this slice replaced, over the same step: one step at
    a time with a Python position, all-rows-finished read every
    ``FINISH_CHECK_EVERY`` steps."""
    config, dec = model.config, model.decoder
    layout = TW.token_layout(config.n_vocab)
    b, p_len = prompt.shape
    t_max = p_len + max_new
    cache = TW.init_kv_cache(config, b, t_max, enc.dtype, enc.device)
    ckv = TW.precompute_cross_kv(dec, enc)
    suppress = torch.from_numpy(TW._suppress_mask(config))
    begin = torch.from_numpy(TW._sample_begin_mask(config))
    tokens = torch.full((b, t_max), layout.eot, dtype=torch.long)
    tokens[:, :p_len] = prompt
    no_speech = TW._prefill(dec, tokens, p_len, cache, ckv, 0, layout)
    finished = torch.zeros(b, dtype=torch.bool)
    sum_lp = torch.zeros(b)
    zero = torch.zeros(())
    pos = p_len
    while pos < t_max:
        logits = TW._decoder_step(dec, tokens[:, pos - 1], pos - 1, cache, ckv)
        logits = logits + suppress + torch.where((prompt_len == pos)[:, None], begin[None, :],
                                                 zero)
        logprobs = torch.log_softmax(logits, dim=-1)
        next_tok = torch.where(finished, layout.eot, torch.argmax(logits, dim=-1))
        sum_lp = sum_lp + torch.where(finished, zero, torch.gather(logprobs, 1,
                                                                    next_tok[:, None])[:, 0])
        tokens[:, pos] = next_tok
        finished = finished | (next_tok == layout.eot)
        pos += 1
        if (pos - p_len) % TW.FINISH_CHECK_EVERY == 0 and bool(finished.all()):
            break
    is_eot = (tokens == layout.eot) & (torch.arange(t_max)[None, :] >= p_len)
    first_eot = torch.where(is_eot.any(dim=1), torch.argmax(is_eot.to(torch.int32), dim=1),
                            torch.full((b,), pos))
    return TW.DecodeResult(tokens, first_eot, sum_lp, no_speech)


@pytest.fixture(scope="module")
def eot_prone():
    """The ``test`` model with its eot embedding turned towards the tokens
    it generates, so rows of different loudness finish at different steps;
    scale 0.85 leaves two of four rows unfinished at 40 steps, 0.88
    finishes all four (lengths measured on these inputs: 44/9/17/44 and
    5/6/12/34 with the 4-token prompt)."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    eot = TW.token_layout(config.n_vocab).eot
    rng = np.random.default_rng(5)
    loud = np.array([0.3, 1.0, 2.0, 4.0], np.float32)[:, None, None]
    mel = torch.from_numpy(rng.normal(0, 1, (4, config.n_mels, 200)).astype(np.float32) * loud)
    prompt = torch.tensor(np.tile(TW.build_prompt(config, "en"), (4, 1)))
    base = TW.build_model(config, params, torch.device("cpu"))
    first = TW.greedy_decode(base, base.encoder(mel), prompt, torch.full((4,), 4), 24)
    table = params["decoder"]["tok"]
    u = table[first.tokens[:, 4:].reshape(-1).numpy()].mean(0)
    u = u / np.linalg.norm(u) * np.linalg.norm(table, axis=1).mean()
    out = {}
    for scale in (0.85, 0.88):
        p = {**params, "decoder": {**params["decoder"], "tok": table.copy()}}
        p["decoder"]["tok"][eot] = scale * u
        model = TW.build_model(config, p, torch.device("cpu"))
        out[scale] = (model, p, model.encoder(mel), prompt)
    return out


@pytest.mark.parametrize("scale,max_new", [(0.85, 40), (0.88, 40), (0.85, 12), (0.88, 20),
                                           (0.85, 3)])
def test_chunked_loop_equals_per_step_loop(eot_prone, scale, max_new):
    model, _, enc, prompt = eot_prone[scale]
    plen = torch.full((4,), prompt.shape[1])
    got = TW.greedy_decode(model, enc, prompt, plen, max_new)
    ref = _per_step_greedy(model, enc, prompt, plen, max_new)
    assert torch.equal(got.tokens, ref.tokens)
    assert torch.equal(got.lengths, ref.lengths)
    assert torch.equal(got.sum_logprob, ref.sum_logprob)
    assert torch.equal(got.no_speech_prob, ref.no_speech_prob)


def test_rows_finish_in_different_chunks(eot_prone):
    """The inputs above do what the loop tests rely on."""
    lengths = {}
    for scale in (0.85, 0.88):
        model, _, enc, prompt = eot_prone[scale]
        res = TW.greedy_decode(model, enc, prompt, torch.full((4,), 4), 40)
        lengths[scale] = res.lengths.tolist()
    assert lengths[0.85] == [44, 9, 17, 44]
    assert lengths[0.88] == [5, 6, 12, 34]


@pytest.mark.parametrize("scale", [0.85, 0.88])
def test_chunked_loop_matches_jax(eot_prone, scale):
    model, params, enc, prompt = eot_prone[scale]
    config = model.config
    jparams = jax.tree.map(jnp.asarray, params)
    plen = np.full((4,), prompt.shape[1], np.int32)
    ref = JW.greedy_decode(jparams, jnp.asarray(enc.numpy()), jnp.asarray(prompt.numpy(), jnp.int32),
                           jnp.asarray(plen), None, JW.get_config(config.name),
                           config.n_text_head, 40)
    got = TW.greedy_decode(model, enc, prompt, torch.from_numpy(plen), 40)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob), rtol=1e-5)


def test_decode_state_is_reused_in_place(eot_prone):
    """Two groups on one state: the second's result is its own, and the
    first's (copied out) is unchanged by it."""
    model, _, enc, prompt = eot_prone[0.85]
    dec = model.decoder
    state = TW.init_decode_state(model.config, 4, 4, 40, torch.float32, torch.device("cpu"))
    results = []
    for rows in (enc, enc.flip(0)):
        ckv = TW.precompute_cross_kv(dec, rows)
        ns = TW.start_decode(dec, state, prompt, torch.full((4,), 4), ckv)
        for _ in range(5):
            TW._decode_chunk(dec, state, ckv)
        results.append(TW.finish_decode(state, 4, ns))
    first = TW.greedy_decode(model, enc, prompt, torch.full((4,), 4), 40)
    second = TW.greedy_decode(model, enc.flip(0), prompt, torch.full((4,), 4), 40)
    assert torch.equal(results[0].tokens, first.tokens)
    assert torch.equal(results[1].tokens, second.tokens)
    assert torch.equal(results[1].sum_logprob, second.sum_logprob)
    assert not torch.equal(results[0].tokens, results[1].tokens)


# -- the graph cache and prewarm ------------------------------------------------


def _engine(**kw):
    return TE.WhisperEngine("test", device="cpu", compute_type=kw.pop("compute_type", "float32"),
                            **kw)


@pytest.mark.parametrize("bucket,max_decode", [(b, m) for b in TE.DEFAULT_AUDIO_BUCKETS_SEC
                                               for m in (8, 16, 64, 224, 448)])
def test_max_new_for_is_a_multiple_of_the_chunk(bucket, max_decode):
    assert TE.max_new_for(bucket, max_decode) % TW.FINISH_CHECK_EVERY == 0


@pytest.mark.parametrize("max_decode", [0, 12, 100])
def test_engine_takes_any_positive_bound(max_decode):
    """0 stays refused; a bound off the 8-step chunk serves, each bucket's
    decode stopping at it (``tests/test_torch_decode_bound.py`` holds the
    tokens to the JAX engine's)."""
    if max_decode <= 0:
        with pytest.raises(ValueError, match="positive"):
            _engine(max_decode_tokens=max_decode)
        return
    engine = _engine(max_decode_tokens=max_decode)
    out = engine.transcribe_sync(TE.DecodeRequest(np.zeros(16000, np.float32), language="en"))
    assert out._n_gen <= engine._max_new_for(1.0) <= max_decode


def test_graph_key_takes_max_new_off_the_chunk():
    graphs = _engine().graphs
    with pytest.raises(ValueError, match="positive"):
        graphs.key(1.0, 1, 4, 0)
    for max_new, chunks, tail in ((12, 1, 4), (20, 2, 4), (24, 3, 0)):
        assert graphs.key(1.0, 1, 4, max_new).max_new == max_new
        entry = graphs.entry(1.0, 1, 4, max_new, 50)
        assert (entry.chunks, entry.tail) == (chunks, tail)
        assert entry.state.tokens.shape == (1, 4 + max_new)


def test_graph_cache_separates_shapes_and_policies_and_reuses_entries():
    eng = _engine()
    graphs = eng.graphs
    first = graphs.entry(1.0, 1, 4, 24, 50)
    assert graphs.entry(1.0, 1, 4, 24, 50) is first
    others = [graphs.entry(2.0, 1, 4, 24, 100), graphs.entry(1.0, 4, 4, 24, 50),
              graphs.entry(1.0, 1, 5, 24, 50), graphs.entry(1.0, 1, 4, 32, 50)]
    assert len({id(e) for e in [first, *others]}) == 5 == len(graphs)
    assert first.state.tokens.shape == (1, 28) and first.cross_kv.k.shape[3] == 50
    assert first.graph is None and graphs.graph_captures == 0
    with pytest.raises(ValueError, match="encoder positions"):
        graphs.entry(1.0, 1, 4, 24, 100)
    keys = {graphs.key(1.0, 1, 4, 24),
            _engine(xattn_kernel="mm").graphs.key(1.0, 1, 4, 24),
            _engine(flash_attention="auto").graphs.key(1.0, 1, 4, 24),
            _engine(compute_type="bfloat16").graphs.key(1.0, 1, 4, 24),
            _engine(compute_type="bfloat16", cross_kv_dtype="fp8").graphs.key(1.0, 1, 4, 24)}
    assert len(keys) == 5


def test_cross_kv_buffers_take_the_policy_storage():
    eng = _engine(compute_type="bfloat16")
    entry = eng.graphs.entry(1.0, 4, 4, 24, 50)
    assert entry.cross_kv.k.dtype == torch.int8 and entry.cross_kv.k_scale.shape[-2:] == (1, 1)
    fp8 = _engine(compute_type="bfloat16", cross_kv_dtype="fp8").graphs.entry(1.0, 4, 4, 24, 50)
    assert fp8.cross_kv.k.dtype == torch.float8_e4m3fn and fp8.cross_kv.k_scale is None
    enc = torch.randn(4, 50, eng.config.n_text_state).to(torch.bfloat16)
    dec = eng.model.decoder
    ref = TW.precompute_cross_kv(dec, enc)
    got = TW.precompute_cross_kv(dec, enc, out=entry.cross_kv)
    assert got is entry.cross_kv
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_engine_serves_through_one_entry_per_shape():
    eng = _engine(max_decode_tokens=16)
    audio = np.zeros(8000, np.float32)
    for _ in range(2):
        eng.transcribe_sync(TE.DecodeRequest(audio, language="en"))
    assert len(eng.graphs) == 1
    eng.transcribe_sync(TE.DecodeRequest(np.zeros(24000, np.float32), language="en"))
    assert len(eng.graphs) == 2
    assert eng.graph_captures == eng.graph_replays == 0


def test_prewarm_runs_each_combination_once(monkeypatch):
    eng = _engine(max_decode_tokens=8, batch_buckets=(1, 4))
    seen = []
    real = eng._device_phase

    def spy(group):
        ctx = real(group)
        seen.append((ctx["bucket_sec"], ctx["batch_n"], ctx["n"]))
        return ctx

    monkeypatch.setattr(eng, "_device_phase", spy)
    sec = eng.prewarm([1.0, 2.0], [1, 4])
    assert isinstance(sec, float) and sec > 0
    assert sorted(seen) == [(1.0, 1, 1), (1.0, 4, 4), (2.0, 1, 1), (2.0, 4, 4)]
    assert len(eng.graphs) == 4
    seen.clear()
    eng.prewarm()
    assert sorted(seen) == [(b, 1, 1) for b in TE.DEFAULT_AUDIO_BUCKETS_SEC]
    seen.clear()
    eng.prewarm([1.0], [4], beam_sizes=[1], include_detect=True, parallelism=4)
    assert seen == [(1.0, 4, 4)]
    assert len(eng.graphs) == 4 + len(TE.DEFAULT_AUDIO_BUCKETS_SEC) - 2


@pytest.mark.parametrize("kwargs,name", [({"mode": "aot"}, "mode")])
def test_prewarm_refuses_what_it_does_not_serve(kwargs, name):
    eng = _engine(max_decode_tokens=16)
    with pytest.raises(NotImplementedError, match=name):
        eng.prewarm([1.0], [1], **kwargs)
    assert len(eng.graphs) == 0


def test_prewarm_include_drafted_builds_drafted_entries_at_beam_1(monkeypatch):
    """``include_drafted`` adds one drafted group per (bucket, rows), at beam
    1 only, whatever the beam widths; each drafted entry shares its greedy
    entry's self cache and cross K/V."""
    eng = _engine(max_decode_tokens=8, batch_buckets=(1, 4))
    seen = []
    real = eng._device_phase

    def spy(group):
        ctx = real(group)
        seen.append((ctx["bucket_sec"], ctx["batch_n"], ctx["beam"], ctx["drafted"]))
        return ctx

    monkeypatch.setattr(eng, "_device_phase", spy)
    eng.prewarm([1.0], [1, 4], beam_sizes=[1, 2], include_drafted=True)
    assert sorted(seen) == sorted((1.0, r, b, d) for r in (1, 4)
                                  for b, d in ((1, False), (2, False), (1, True)))
    drafted = [e for k, e in eng.graphs._entries.items() if k.drafted]
    assert len(drafted) == 2 and all(e.key.beam == 1 for e in drafted)
    for e in drafted:
        plain = eng.graphs.lookup(e.key.bucket_sec, e.key.rows, e.key.p_len, e.key.max_new)
        assert e.state.cache is plain.state.cache and e.cross_kv is plain.cross_kv


def test_prewarm_builds_beam_entries(monkeypatch):
    """Beam widths are prewarmed (clamped to 1..8), each (bucket, rows, beam)
    once, into entries of their own."""
    eng = _engine(max_decode_tokens=8, batch_buckets=(1, 4))
    seen = []
    real = eng._device_phase

    def spy(group):
        ctx = real(group)
        seen.append((ctx["bucket_sec"], ctx["batch_n"], ctx["beam"]))
        return ctx

    monkeypatch.setattr(eng, "_device_phase", spy)
    eng.prewarm([1.0, 2.0], [1, 4], beam_sizes=[1, 5, 5, 12])
    assert sorted(seen) == sorted((s, r, b) for s in (1.0, 2.0) for r in (1, 4)
                                  for b in (1, 5, 8))
    assert sorted((k.beam, k.rows) for k in eng.graphs._entries) == sorted(
        (b, r) for _ in (1.0, 2.0) for r in (1, 4) for b in (1, 5, 8))
