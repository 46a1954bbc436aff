"""Drafted partials in the port against the JAX package, on the CPU.

The port's ``greedy_decode_drafted`` is held against
``stt_tpu.models.whisper.greedy_decode_drafted`` on the float32 ``test``
model with the same seed-0 weights and the same encoder output, for the
draft cases of ``tests/test_draft_decode.py``: empty, perfect, adversarial,
mid-mutation, mixed batch, eot tail and truncated. Tokens, lengths and
accepted counts must be equal; the logprob sum and p(no_speech) within
1e-5. Every drafted result must also equal the port's own plain greedy
decode. The random ``test`` model never writes an eot within its budget, so
the eot cases run on a copy whose eot embedding is 1.05 times that of the
fourth token greedy writes: greedy then stops after three tokens.

Then the pieces the port adds: the decoder step at per-row positions
against the scalar step, the drafted resume in chunks of 1 and of 8
(identical state), the drafted entry of the decode graphs (its result and
the buffers it shares with the greedy entry), and the engine's routing,
draft store and adaptive engagement, mirroring ``tests/test_draft_decode.py``
on the port's engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu.ops.mel import log_mel_spectrogram
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.engine.graphs import DecodeGraphs
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CFG = JW.PRESETS["test"]
MAX_NEW = 12
P_LEN = 4
EOT = JW.token_layout(CFG.n_vocab).eot
ATOL = 1e-5


def _decode_pair(tree):
    """(JAX params, port model) from one numpy tree."""
    config = TW.get_config("test")
    return (jax.tree.map(jnp.asarray, tree),
            TW.build_model(config, tree, torch.device("cpu")))


@pytest.fixture(scope="module")
def base():
    tree = TW.init_params(TW.get_config("test"), seed=0)
    jparams, model = _decode_pair(tree)
    rng = np.random.default_rng(7)
    audio = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    mel = log_mel_spectrogram(jnp.asarray(audio))[None]
    enc = np.array(JW.encode(jparams, mel, CFG.n_audio_head))
    return tree, jparams, model, enc


@pytest.fixture(scope="module")
def models(base):
    """name -> (JAX params, port model, encoder output, greedy's tokens)."""
    tree, jparams, model, enc = base
    out = {"test": (jparams, model, enc, _greedy_gen(model, enc))}
    gen = out["test"][3]
    assert len(gen) == MAX_NEW, gen
    eot_tree = jax.tree.map(np.copy, tree)
    eot_tree["decoder"]["tok"][EOT] = 1.05 * eot_tree["decoder"]["tok"][gen[3]]
    jp, m = _decode_pair(eot_tree)
    eot_gen = _greedy_gen(m, enc)
    assert 0 < len(eot_gen) < MAX_NEW - 3, eot_gen
    out["eot"] = (jp, m, enc, eot_gen)
    return out


def _prompt(batch: int) -> np.ndarray:
    return np.tile(np.array([JW.build_prompt(CFG, "en")], np.int64), (batch, 1))


def _greedy(model, enc, batch: int = 1) -> TW.DecodeResult:
    return TW.greedy_decode(model, torch.from_numpy(np.tile(enc, (batch, 1, 1))),
                            torch.from_numpy(_prompt(batch)), torch.full((batch,), P_LEN),
                            MAX_NEW)


def _greedy_gen(model, enc) -> list:
    res = _greedy(model, enc)
    return res.tokens[0, P_LEN:int(res.lengths[0])].tolist()


def _draft_array(rows):
    width = max(1, max(len(r) for r in rows))
    draft = np.full((len(rows), width), EOT, np.int64)
    for i, r in enumerate(rows):
        draft[i, :len(r)] = r
    return draft, np.array([len(r) for r in rows], np.int64)


def _drafted_pair(jparams, model, enc, rows):
    b = len(rows)
    draft, dlen = _draft_array(rows)
    enc_b = np.tile(enc, (b, 1, 1))
    prompt = _prompt(b)
    j = JW.greedy_decode_drafted(
        jparams, jnp.asarray(enc_b), jnp.asarray(prompt, jnp.int32),
        jnp.full((b,), P_LEN, jnp.int32), jnp.asarray(draft, jnp.int32),
        jnp.asarray(dlen, jnp.int32), CFG, CFG.n_text_head, max_new_tokens=MAX_NEW)
    t = TW.greedy_decode_drafted(
        model, torch.from_numpy(enc_b), torch.from_numpy(prompt), torch.full((b,), P_LEN),
        torch.from_numpy(draft), torch.from_numpy(dlen), MAX_NEW)
    return j, t


def _case_rows(case: str, gen: list) -> list:
    rng = np.random.default_rng(11)
    if case == "empty":
        return [[]]
    if case == "perfect":
        return [gen]
    if case == "adversarial":
        return [rng.integers(10, 400, size=MAX_NEW).tolist()]
    if case == "mid_mutation":
        cut = len(gen) // 2
        return [gen[:cut] + [(gen[cut] + 1) % 400 + 10] + gen[cut + 1:]]
    if case == "mixed":
        return [gen, [], rng.integers(10, 400, size=6).tolist(), gen[:1]]
    if case == "eot_tail":
        return [gen + [EOT, 42, 43]]
    assert case == "truncated"
    return [gen[:-1]]


CASES = [("test", c) for c in ("empty", "perfect", "adversarial", "mid_mutation", "mixed",
                               "truncated")]
CASES += [("eot", c) for c in ("eot_tail", "mixed", "perfect", "mid_mutation")]


@pytest.mark.parametrize("name,case", CASES)
def test_drafted_equals_jax_and_plain_greedy(models, name, case):
    jparams, model, enc, gen = models[name]
    rows = _case_rows(case, gen)
    j, t = _drafted_pair(jparams, model, enc, rows)
    for field in ("tokens", "lengths", "n_accepted"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)
    for field in ("sum_logprob", "no_speech_prob"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                   rtol=0, atol=ATOL, err_msg=field)
    plain = _greedy(model, enc, len(rows))
    assert torch.equal(t.tokens, plain.tokens) and torch.equal(t.lengths, plain.lengths)
    np.testing.assert_allclose(t.sum_logprob.numpy(), plain.sum_logprob.numpy(),
                               rtol=0, atol=ATOL)
    expect = {"empty": [0], "perfect": [len(gen)], "truncated": [len(gen) - 1],
              "mid_mutation": [len(gen) // 2]}
    if case in expect:
        assert t.n_accepted.tolist() == expect[case]
    if case == "eot_tail":
        # the accepted eot ends the row: the verify pass did everything
        assert t.n_accepted.tolist() == [len(gen) + 1]


def test_budget_full_draft_finishes_in_the_verify_pass(models):
    """A perfect draft as long as max_new commits nothing and leaves every
    row finished: no resume step runs."""
    _, model, enc, gen = models["test"]
    draft, dlen = _draft_array([gen])
    st = TW.init_draft_state(model.config, 1, P_LEN, MAX_NEW, MAX_NEW, torch.float32,
                             torch.device("cpu"))
    ckv = TW.precompute_cross_kv(model.decoder, torch.from_numpy(enc))
    TW.start_drafted(model.decoder, st, torch.from_numpy(_prompt(1)), torch.full((1,), P_LEN),
                     torch.from_numpy(draft), torch.from_numpy(dlen), ckv)
    assert st.finished.tolist() == [True]
    assert st.pos.tolist() == [P_LEN + MAX_NEW]
    assert st.tokens[0, P_LEN:].tolist() == gen


def _cache_after_prefill(model, enc, batch: int, width: int):
    tokens = torch.from_numpy(np.tile(np.arange(100, 100 + width), (batch, 1)))
    cache = TW.init_kv_cache(model.config, batch, P_LEN + MAX_NEW, torch.float32,
                             torch.device("cpu"))
    ckv = TW.precompute_cross_kv(model.decoder, torch.from_numpy(np.tile(enc, (batch, 1, 1))))
    TW._prefill_parallel(model.decoder, tokens, width, cache, ckv)
    return cache, ckv


def test_vector_position_step_matches_jax(base):
    """Rows at positions 3, 11 and 7 over a 16-slot cache whose every slot
    holds values: logits and the written cache agree with the JAX
    package's vector-``pos`` step within 1e-5."""
    _, jparams, model, enc = base
    config = model.config
    b, t_max, h = 3, 16, config.n_text_head
    shape = (config.n_text_layer, b, h, t_max, config.n_text_state // h)
    rng = np.random.default_rng(5)
    k0, v0 = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, 50000, b)
    pos = np.array([3, 11, 7])
    enc_b = np.tile(enc, (b, 1, 1))
    ref_logits, ref_cache = JW._decoder_step(
        jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32),
        JW.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
        JW.precompute_cross_kv(jparams, jnp.asarray(enc_b), h), h, jnp.asarray(pos, jnp.int32))
    cache = TW.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    logits = TW._decoder_step(model.decoder, torch.from_numpy(tokens), torch.from_numpy(pos),
                              cache, TW.precompute_cross_kv(model.decoder,
                                                            torch.from_numpy(enc_b)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref_cache.v), rtol=0, atol=1e-5)


def test_vector_position_step_equals_scalar_step(base):
    """All positions equal: the per-row step gives the scalar step's
    logits and cache bit for bit."""
    _, _, model, enc = base
    tokens = torch.tensor([7, 300, 45])
    caches = [_cache_after_prefill(model, enc, 3, 6) for _ in range(2)]
    scalar = TW._decoder_step(model.decoder, tokens, torch.tensor(6), *caches[0])
    rows = TW._decoder_step(model.decoder, tokens, torch.full((3,), 6), *caches[1])
    assert torch.equal(scalar, rows)
    assert torch.equal(caches[0][0].k, caches[1][0].k)
    assert torch.equal(caches[0][0].v, caches[1][0].v)


def test_vector_position_step_per_row(base):
    """Rows at different positions: each written row's logits and cache are
    what a scalar step of that row alone gives; a gated row keeps its
    cache (it attends over what its slot held, so its logits are not
    compared)."""
    _, _, model, enc = base
    pos = torch.tensor([4, 9, 6])
    tokens = torch.tensor([7, 300, 45])
    gate = torch.tensor([True, True, False])
    cache, ckv = _cache_after_prefill(model, enc, 3, 10)
    before = cache.k.clone()
    logits = TW._decoder_step(model.decoder, tokens, pos, cache, ckv, gate=gate)
    for b in range(3):
        one, one_ckv = _cache_after_prefill(model, enc, 1, 10)
        ref = TW._decoder_step(model.decoder, tokens[b:b + 1], pos[b], one, one_ckv)
        if gate[b]:
            np.testing.assert_allclose(logits[b].numpy(), ref[0].numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(cache.k[:, b].numpy(), one.k[:, 0].numpy(),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(cache.v[:, b].numpy(), one.v[:, 0].numpy(),
                                       rtol=0, atol=1e-5)
    assert torch.equal(cache.k[:, 2], before[:, 2])


@pytest.mark.parametrize("name", ["test", "eot"])
def test_chunks_of_one_and_eight_leave_identical_state(models, name):
    """Every update of a finished row is gated, so the host may read the
    stop once a chunk: 8 chunks of 1 step and 1 chunk of 8 leave every
    buffer equal, over max_new steps (rows finishing at different steps)."""
    _, model, enc, gen = models[name]
    rows = _case_rows("mixed", gen)
    draft, dlen = _draft_array(rows)
    b = len(rows)
    ckv = TW.precompute_cross_kv(model.decoder, torch.from_numpy(np.tile(enc, (b, 1, 1))))
    states = []
    for step in (1, 8):
        st = TW.init_draft_state(model.config, b, P_LEN, MAX_NEW, draft.shape[1],
                                 torch.float32, torch.device("cpu"))
        TW.start_drafted(model.decoder, st, torch.from_numpy(_prompt(b)),
                         torch.full((b,), P_LEN), torch.from_numpy(draft),
                         torch.from_numpy(dlen), ckv)
        for _ in range(16 // step):
            TW._drafted_chunk(model.decoder, st, ckv, step)
        states.append(st)
    assert bool(states[0].finished.all())
    for field, x in states[0]._asdict().items():
        y = getattr(states[1], field)
        if isinstance(x, TW.KVCache):
            assert torch.equal(x.k, y.k) and torch.equal(x.v, y.v), field
        else:
            assert torch.equal(x, y), field


def test_drafted_entry_decodes_and_shares_the_greedy_buffers(models):
    _, model, enc, gen = models["eot"]
    rows = _case_rows("mixed", gen)
    b = len(rows)
    graphs = DecodeGraphs(model, torch.device("cpu"), torch.float32)
    max_new = 16
    entry = graphs.entry(1.0, b, P_LEN, max_new, enc.shape[1], drafted=True)
    plain = graphs.lookup(1.0, b, P_LEN, max_new)
    assert len(graphs) == 2 and entry.key.drafted and not plain.key.drafted
    assert entry.state.cache is plain.state.cache and entry.cross_kv is plain.cross_kv
    enc_b = torch.from_numpy(np.tile(enc, (b, 1, 1)))
    TW.precompute_cross_kv(model.decoder, enc_b, out=entry.cross_kv)
    draft = np.full((b, max_new), EOT, np.int64)
    d, dlen = _draft_array(rows)
    draft[:, :d.shape[1]] = d
    got = graphs.decode(entry, torch.from_numpy(_prompt(b)), torch.full((b,), P_LEN),
                        draft=torch.from_numpy(draft), draft_len=torch.from_numpy(dlen))
    ref = TW.greedy_decode_drafted(model, enc_b, torch.from_numpy(_prompt(b)),
                                   torch.full((b,), P_LEN), torch.from_numpy(draft),
                                   torch.from_numpy(dlen), max_new)
    for field in ("tokens", "lengths", "sum_logprob", "n_accepted"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    with pytest.raises(ValueError, match="draft"):
        graphs.decode(entry, torch.from_numpy(_prompt(b)), torch.full((b,), P_LEN))
    with pytest.raises(ValueError, match="beam 1"):
        graphs.key(1.0, b, P_LEN, max_new, beam=5, drafted=True)


# ---------------------------------------------------------------------------
# the engine: routing, the draft store, adaptive engagement
# ---------------------------------------------------------------------------


def _audio(dur=0.8, seed=11):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16000 * dur))).astype(np.float32)


def _new_engine(mode, **kw):
    opts = dict(device="cpu", compute_type="float32", audio_buckets_sec=(1.0, 2.0),
                batch_buckets=(1, 2, 4), max_decode_tokens=32, batch_window_ms=20.0,
                max_batch=4)
    opts.update(kw)
    return TE.WhisperEngine("test", draft_mode=mode, **opts)


@pytest.fixture(scope="module")
def draft_engine():
    eng = _new_engine("on")
    yield eng
    eng.close()


def _req(audio, sid="", final=False, language="en"):
    return TE.DecodeRequest(audio=audio, language=language, is_final=final, session_id=sid)


def _texts(out):
    return [s.text for s in out.segments]


def test_engine_drafted_partials_token_identical(draft_engine):
    audio = _audio()
    base = draft_engine.transcribe_sync(_req(audio))
    p1 = draft_engine.transcribe_sync(_req(audio, "drafts1"))
    before = dict(draft_engine.draft_stats)
    p2 = draft_engine.transcribe_sync(_req(audio, "drafts1"))
    after = dict(draft_engine.draft_stats)
    assert _texts(p1) == _texts(base) == _texts(p2)
    assert p1._n_gen > 0
    np.testing.assert_array_equal(p2._tokens, base._tokens)
    assert after["rows"] == before["rows"] + 1
    assert after["accepted"] - before["accepted"] == p1._n_gen


def test_engine_final_evicts_draft(draft_engine):
    audio = _audio(seed=12)
    p1 = draft_engine.transcribe_sync(_req(audio, "drafts2"))
    assert p1._n_gen > 0 and len(draft_engine._draft_get("drafts2")) == p1._n_gen
    draft_engine.transcribe_sync(_req(audio, "drafts2", final=True))
    assert len(draft_engine._draft_get("drafts2")) == 0


def test_engine_final_consumes_draft(draft_engine):
    audio = _audio(seed=31)
    base = draft_engine.transcribe_sync(_req(audio, final=True))
    p1 = draft_engine.transcribe_sync(_req(audio, "drafts-final"))
    before = dict(draft_engine.draft_stats)
    fin = draft_engine.transcribe_sync(_req(audio, "drafts-final", final=True))
    after = dict(draft_engine.draft_stats)
    assert _texts(fin) == _texts(base)
    assert after["accepted"] - before["accepted"] == p1._n_gen > 0
    assert len(draft_engine._draft_get("drafts-final")) == 0


def test_engine_final_without_draft_stays_plain(draft_engine):
    before = dict(draft_engine.draft_stats)
    out = draft_engine.transcribe_sync(_req(_audio(seed=32), "drafts-fresh-final", final=True))
    assert out.segments is not None
    assert dict(draft_engine.draft_stats) == before


def test_engine_drafted_and_plain_batch_split(draft_engine, monkeypatch):
    """A drafted partial and a plain final in one batch window form two
    groups, on the drafted and the greedy entry, and both succeed."""
    audio = _audio(seed=13)
    seen = []
    real = draft_engine._device_phase

    def spy(group):
        seen.append(sorted((t.draft is not None, t.request.session_id) for t in group))
        return real(group)

    monkeypatch.setattr(draft_engine, "_device_phase", spy)
    f1 = draft_engine.submit(_req(audio, "drafts3"))
    f2 = draft_engine.submit(_req(audio, "drafts4", final=True))
    assert _texts(f1.result(timeout=120)) == _texts(f2.result(timeout=120))
    assert sorted(seen) == [[(False, "drafts4")], [(True, "drafts3")]]


def test_engine_drafted_auto_language(draft_engine):
    audio = _audio(seed=51)
    base = draft_engine.transcribe_sync(_req(audio, language=None))
    p1 = draft_engine.transcribe_sync(_req(audio, "drafts-auto", language=None))
    p2 = draft_engine.transcribe_sync(_req(audio, "drafts-auto", language=None))
    assert p1.info.language == p2.info.language == base.info.language
    assert _texts(p2) == _texts(base)


def test_engine_drafted_beam_requests_stay_plain(draft_engine):
    """Beam requests are not eligible: no draft is stored or offered."""
    before = dict(draft_engine.draft_stats)
    req = _req(_audio(seed=52), "drafts-beam")
    req.options = {"beam_size": 5}
    draft_engine.transcribe_sync(req)
    draft_engine.transcribe_sync(req)
    assert dict(draft_engine.draft_stats) == before
    assert len(draft_engine._draft_get("drafts-beam")) == 0


def test_adaptive_starts_plain_and_engages_on_high_acceptance():
    eng = _new_engine("adaptive")
    audio = _audio(seed=31)
    try:
        def tick():
            return eng.transcribe_sync(_req(audio, "adapt1"))

        p1 = tick()
        assert p1._n_gen > 0
        for i in range(4):
            tick()
            st = eng.draft_stats
            assert st["offered"] == 0 or st["engaged"], (i, st)
            if st["engaged"]:
                break
        st = dict(eng.draft_stats)
        assert st["engaged"] and st["hyp_offered"] > 0, st
        assert st["hyp_accepted"] == st["hyp_offered"], st
        before = dict(eng.draft_stats)
        out = tick()
        after = dict(eng.draft_stats)
        assert after["offered"] > before["offered"]
        assert after["accepted"] > before["accepted"]
        assert _texts(out) == _texts(p1)
    finally:
        eng.close()


def test_adaptive_disengages_on_low_acceptance():
    eng = _new_engine("adaptive")
    audio = _audio(seed=32)
    try:
        def tick():
            return eng.transcribe_sync(_req(audio, "adapt2"))

        p1 = tick()
        assert p1._n_gen > 1
        for _ in range(4):
            tick()
            if eng.draft_stats["engaged"]:
                break
        assert eng.draft_stats["engaged"]
        garbage = np.full(max(2, p1._n_gen), 77, np.int32)
        for _ in range(8):
            eng._draft_put("adapt2", garbage)
            tick()
            if not eng.draft_stats["engaged"]:
                break
        assert not eng.draft_stats["engaged"], eng.draft_stats
        before = dict(eng.draft_stats)
        tick()
        tick()
        after = dict(eng.draft_stats)
        assert after["offered"] == before["offered"], (before, after)
        assert after["hyp_offered"] > before["hyp_offered"]
    finally:
        eng.close()


def test_adaptive_mode_off_never_stores_or_routes():
    eng = _new_engine("off", audio_buckets_sec=(1.0,), batch_buckets=(1,),
                      max_decode_tokens=16, batch_window_ms=0.0, max_batch=1)
    try:
        for _ in range(3):
            eng.transcribe_sync(_req(_audio(seed=33), "off1"))
        st = dict(eng.draft_stats)
        assert st["offered"] == 0 and st["hyp_offered"] == 0, st
        assert len(eng._draft_get("off1")) == 0
        assert not any(k.drafted for k in eng.graphs._entries)
    finally:
        eng.close()


def test_draft_mode_is_checked():
    with pytest.raises(ValueError, match="draft_mode"):
        _new_engine("sometimes")


def test_draft_store_is_an_lru_of_2048(monkeypatch):
    eng = _new_engine("on")
    try:
        for i in range(TE.DRAFT_STORE_CAP + 2):
            eng._draft_put(f"s{i}", np.array([i], np.int32))
        eng._draft_get("s2")  # touched: kept
        eng._draft_put("new", np.array([1], np.int32))
        assert len(eng._drafts) == TE.DRAFT_STORE_CAP
        assert len(eng._draft_get("s0")) == len(eng._draft_get("s1")) == 0
        assert len(eng._draft_get("s3")) == 0 and eng._draft_get("s2").tolist() == [2]
    finally:
        eng.close()


class _Recorder:
    """The metrics hook's draft calls."""

    def __init__(self):
        self.calls = []

    def record_draft_verify(self, *args):
        self.calls.append(("verify",) + args)

    def record_draft_signal(self, *args):
        self.calls.append(("signal",) + args)

    def record_engine_batch(self, *args):
        pass

    def record_engine_compile(self, *args):
        pass


def test_metrics_hook_receives_verify_and_signal():
    rec = _Recorder()
    eng = _new_engine("adaptive", metrics=rec)
    try:
        for _ in range(5):
            eng.transcribe_sync(_req(_audio(seed=34), "metrics1"))
    finally:
        eng.close()
    signals = [c for c in rec.calls if c[0] == "signal"]
    verifies = [c for c in rec.calls if c[0] == "verify"]
    assert signals and signals[0][1] == signals[0][2] > 0
    assert signals[-1][4] is True          # engaged after three full-LCP observations
    assert verifies and verifies[-1][2] == verifies[-1][3] > 0   # offered == accepted


def test_prewarm_builds_drafted_entries():
    eng = _new_engine("adaptive", batch_buckets=(1, 4), max_decode_tokens=16)
    try:
        eng.prewarm([1.0, 2.0], [1, 4], include_drafted=True)
        keys = sorted((k.bucket_sec, k.rows, k.drafted) for k in eng.graphs._entries)
        assert keys == sorted((s, r, d) for s in (1.0, 2.0) for r in (1, 4)
                              for d in (False, True))
        assert eng.draft_stats["offered"] == 0 and not eng._drafts
    finally:
        eng.close()
