"""Repetition penalty and n-gram bans in the port against the JAX package.

On the CPU in float32, on the ``test`` preset with its eot embedding turned
towards the generated tokens (``tests/test_torch_beam.py::_eot_prone``: rows
finish at different steps), the port's ``greedy_decode`` and ``beam_decode``
with ``rep_penalty`` (B,) and ``ngram_n`` are held against the JAX
package's: tokens and lengths exactly, the logprob sum within atol 1e-5
plus rtol 1e-6, p(no_speech) within rtol 1e-5. The penalty differs by row
(one row at 1.0, one below 1), the bans take sizes 1 to 4, beams run
frozen-slot and pooled. The two JAX model tests are mirrored on the port
with their rigged weights (``tests/test_whisper_model.py:594, 638``), and
the pieces are held against theirs on random inputs: the banned-token
mask, the seen-set seed and a chunked penalised beam search (chunks of 1
and 8 leave the same state, every step past the stop gated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_beam import _eot_prone
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

SUM_ATOL, SUM_RTOL = 1e-5, 1e-6
CFG = JW.PRESETS["test"]
EOT = JW.token_layout(CFG.n_vocab).eot


@pytest.fixture(scope="module")
def pair():
    return _eot_prone("test")


def _jnp(x, dtype=jnp.int32):
    return jnp.asarray(np.asarray(x), dtype)


def _check(got, ref):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=SUM_ATOL, rtol=SUM_RTOL)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-5)


RP_ROWS = [1.3, 1.0, 0.7]

# (beam, patience, penalty rows or None, ngram_n, max_new)
CASES = [
    (1, 1.0, RP_ROWS, 0, 20),
    (1, 1.0, None, 1, 12),
    (1, 1.0, RP_ROWS, 4, 20),
    (3, 1.0, None, 2, 20),
    (2, 1.0, RP_ROWS, 3, 12),
    (2, 2.0, RP_ROWS, 2, 20),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_penalised_decode_matches_jax(pair, case):
    beam, patience, rp, ngram, max_new = case
    model, jparams, enc, prompt = pair
    plen = torch.full((3,), 4)
    rp_t = None if rp is None else torch.tensor(rp)
    rp_j = None if rp is None else jnp.asarray(rp, jnp.float32)
    enc_j = jnp.asarray(enc.detach().numpy())
    if beam == 1:
        got = TW.greedy_decode(model, enc, prompt, plen, max_new, rep_penalty=rp_t,
                               ngram_n=ngram)
        ref = JW.greedy_decode(jparams, enc_j, _jnp(prompt), _jnp(plen), None, CFG,
                               CFG.n_text_head, max_new, rep_penalty=rp_j, ngram_n=ngram)
    else:
        got = TW.beam_decode(model, enc, prompt, plen, max_new, beam_size=beam,
                             patience=patience, rep_penalty=rp_t, ngram_n=ngram)
        ref = JW.beam_decode(jparams, enc_j, _jnp(prompt), _jnp(plen), None, CFG,
                             CFG.n_text_head, max_new, beam_size=beam, patience=patience,
                             rep_penalty=rp_j, ngram_n=ngram)
    _check(got, ref)


def test_the_rules_change_the_decode(pair):
    """The cases above exercise the rules: a penalty and a ban each change
    what the plain greedy decode writes."""
    model, _, enc, prompt = pair
    plen = torch.full((3,), 4)
    plain = TW.greedy_decode(model, enc, prompt, plen, 20).tokens
    pen = TW.greedy_decode(model, enc, prompt, plen, 20, rep_penalty=torch.full((3,), 2.0))
    ban = TW.greedy_decode(model, enc, prompt, plen, 20, ngram_n=1)
    assert not torch.equal(plain, pen.tokens) and not torch.equal(plain, ban.tokens)


def _rigged(seed: int, fav: int):
    """``tests/test_whisper_model.py``'s weights rigged so ``fav`` is always
    the argmax, for both packages, with the encoder output of one row."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=seed)
    tok = params["decoder"]["tok"].copy()
    tok[fav] *= 10.0
    params = {**params, "decoder": {**params["decoder"], "tok": tok,
                                    "ln": {"g": np.zeros_like(params["decoder"]["ln"]["g"]),
                                           "b": tok[fav].copy()}}}
    model = TW.build_model(config, params, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    mel = rng.normal(0, 1, (1, config.n_mels, 100)).astype(np.float32)
    enc = model.encoder(torch.from_numpy(mel)).detach()
    return model, jax.tree.map(jnp.asarray, params), enc


PROMPT = torch.tensor([[50258, 50259, 50359, 50363]])


def test_repetition_penalty_discourages_repeats():
    """``tests/test_whisper_model.py:594`` on the port: unpenalised the
    rigged token repeats; at penalty 50 its second occurrence is suppressed;
    the tokens are the JAX package's."""
    fav = 42
    model, jparams, enc = _rigged(10, fav)
    plen = torch.full((1,), 4)
    plain = TW.greedy_decode(model, enc, PROMPT, plen, 6)
    assert (plain.tokens[0, 4:7] == fav).all()
    pen = TW.greedy_decode(model, enc, PROMPT, plen, 6, rep_penalty=torch.tensor([50.0]))
    assert pen.tokens[0, 4] == fav and pen.tokens[0, 5] != fav
    ref = JW.greedy_decode(jparams, jnp.asarray(enc.numpy()), _jnp(PROMPT), _jnp(plen), None,
                           CFG, CFG.n_text_head, 6, rep_penalty=jnp.asarray([50.0]))
    _check(pen, ref)


def test_no_repeat_ngram_blocks_bigram_loop():
    """``tests/test_whisper_model.py:638`` on the port: the rigged token
    loops; ``ngram_n=2`` lets ``fav fav`` stand and bans the third; the
    tokens are the JAX package's."""
    fav = 77
    model, jparams, enc = _rigged(12, fav)
    plen = torch.full((1,), 4)
    plain = TW.greedy_decode(model, enc, PROMPT, plen, 8)
    assert (plain.tokens[0, 4:10] == fav).all()
    banned = TW.greedy_decode(model, enc, PROMPT, plen, 8, ngram_n=2)
    assert banned.tokens[0, 4] == fav and banned.tokens[0, 5] == fav
    assert banned.tokens[0, 6] != fav
    ref = JW.greedy_decode(jparams, jnp.asarray(enc.numpy()), _jnp(PROMPT), _jnp(plen), None,
                           CFG, CFG.n_text_head, 8, ngram_n=2)
    _check(banned, ref)


@pytest.mark.parametrize("n,pos", [(1, 9), (2, 4), (3, 16), (4, 9)])
def test_banned_tokens_equal_jax(n, pos):
    """The banned-token mask of sequences with repeats (a vocabulary of 2)
    at several positions, the tail near the start included."""
    rng = np.random.default_rng(n * 31 + pos)
    tokens = rng.integers(0, 2, (5, 16)).astype(np.int64)
    got = TW._ngram_banned_tokens(torch.from_numpy(tokens), torch.tensor(pos),
                                  torch.arange(n - 1), 8)
    ref = JW._ngram_banned_tokens(_jnp(tokens), jnp.int32(pos), n, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() or pos < 2 * n


def test_seen_text_mask_equal_jax():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CFG.n_vocab, (4, 12)).astype(np.int64)
    tokens[:, 0] = EOT + 1  # a special in the prompt is never seen text
    plen = np.array([12, 5, 1, 0])
    got = TW._seen_text_mask(torch.from_numpy(tokens), torch.from_numpy(plen), EOT, CFG.n_vocab)
    ref = JW._seen_text_mask(_jnp(tokens), _jnp(plen), JW.token_layout(CFG.n_vocab),
                             CFG.n_vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _beam_states(model, enc, prompt, chunk: int, candidates: int):
    dec = model.decoder
    b, p_len = prompt.shape
    route = TW.Route(penalised=True, ngram_n=2)
    st = TW.init_beam_state(model.config, b, 2, candidates, p_len, 12, torch.float32,
                            torch.device("cpu"), route=route)
    ckv = TW.repeat_cross_kv(TW.precompute_cross_kv(dec, enc), 2)
    TW.start_beam(dec, st, prompt, torch.full((b,), p_len), ckv,
                  rep_penalty=torch.tensor(RP_ROWS))
    for _ in range(-(-12 // chunk)):
        TW._beam_chunk(dec, st, ckv, chunk)
        if not bool(TW.beam_running(st)):
            break
    return st


@pytest.mark.parametrize("candidates", [2, 4])
def test_penalised_beam_chunks_of_1_and_8_leave_identical_state(pair, candidates):
    """The seen-sets follow the beams and, like the rest of the state,
    change nothing past the loop's stop (12 new tokens: the last chunk of 8
    runs 4 steps past T_max)."""
    model, _, enc, prompt = pair
    one = _beam_states(model, enc, prompt, 1, candidates)
    eight = _beam_states(model, enc, prompt, 8, candidates)
    for name, a, b in zip(one._fields, one, eight):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if x is not None:
                assert torch.equal(x, y), name
    assert one.rules.seen.any()
