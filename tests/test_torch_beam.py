"""The port's beam search against the JAX package's, on identical weights.

``stt_tpu_torch.models.whisper.beam_decode`` (frozen-slot when
``round(beam * patience) <= beam``, pooled above it) is held against
``stt_tpu.models.whisper.beam_decode`` in float32 on the CPU, on the
``test`` and ``tiny`` presets with the eot embedding turned towards the
generated tokens so that rows finish at different steps: tokens and lengths
exactly, the best beam's logprob sum within atol 1e-5 plus rtol 1e-6 (sums
reach ~140 here, where one float32 step is 7.6e-6; the two frameworks sum
their softmax in different orders). Beams 2, 5 and 8, patience 1 and 2,
length penalty 1 and 0.5, suppress-blank on and off, 1 and 3 rows, 12 and
20 new tokens, and rows whose logical prompt is shorter than the prompt's
width (the frozen-slot search applies the begin mask per row at
``prompt_len``, the pooled one at the width).

The chunked loop reads the loop's condition once per chunk; every step is
gated on it, so chunks of 8 leave the state bit for bit where chunks of 1
stop. Ties go to the lower index as ``lax.top_k``'s do. At beam 1 the search
is the greedy decode. ``tests/test_torch_beam_engine.py`` holds the engine's
beam path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

SUM_ATOL, SUM_RTOL = 1e-5, 1e-6


def _eot_prone(name: str, scale: float = 0.85):
    """``name``'s weights with the eot embedding turned towards the tokens
    greedy generates, so beams finish early and rows of different loudness
    at different steps; with its encoder output of 3 rows and the prompt."""
    config = TW.get_config(name)
    params = TW.init_params(config, seed=0)
    eot = TW.token_layout(config.n_vocab).eot
    rng = np.random.default_rng(5)
    loud = np.array([0.3, 1.0, 4.0], np.float32)[:, None, None]
    mel = torch.from_numpy(rng.normal(0, 1, (3, config.n_mels, 200)).astype(np.float32) * loud)
    prompt = torch.tensor(np.tile(TW.build_prompt(config, "en"), (3, 1)))
    base = TW.build_model(config, params, torch.device("cpu"))
    first = TW.greedy_decode(base, base.encoder(mel), prompt, torch.full((3,), 4), 24)
    table = params["decoder"]["tok"]
    u = table[first.tokens[:, 4:].reshape(-1).numpy()].mean(0)
    u = u / np.linalg.norm(u) * np.linalg.norm(table, axis=1).mean()
    params = {**params, "decoder": {**params["decoder"], "tok": table.copy()}}
    params["decoder"]["tok"][eot] = scale * u
    model = TW.build_model(config, params, torch.device("cpu"))
    return model, jax.tree.map(jnp.asarray, params), model.encoder(mel), prompt


@pytest.fixture(scope="module", params=["test", "tiny"])
def pair(request):
    return _eot_prone(request.param)


# (beam, patience, length_penalty, suppress_blank, max_new, rows, prompt_len)
CASES = [
    (2, 1.0, 1.0, True, 20, 3, (4, 4, 4)),
    (5, 1.0, 0.5, False, 20, 3, (4, 4, 4)),
    (8, 1.0, 1.0, True, 12, 3, (4, 4, 4)),
    (5, 1.0, 1.0, True, 12, 1, (4,)),
    (5, 1.0, 1.0, True, 20, 3, (4, 3, 4)),
    (2, 2.0, 1.0, True, 20, 3, (4, 4, 4)),
    (5, 2.0, 0.5, True, 20, 3, (4, 3, 4)),
    (8, 2.0, 0.5, False, 12, 1, (4,)),
]


_RUNS = {}


def _run_both(pair, beam, patience, lp, sb, max_new, rows, plen):
    """Both packages' beam decodes of one case, each case decoded once per
    model (the checks that reuse a parity case read its result)."""
    key = (pair[0].config.name, beam, patience, lp, sb, max_new, rows, plen)
    if key not in _RUNS:
        _RUNS[key] = _decode_both(pair, beam, patience, lp, sb, max_new, rows, plen)
    return _RUNS[key]


def _decode_both(pair, beam, patience, lp, sb, max_new, rows, plen):
    model, jparams, enc, prompt = pair
    enc, prompt = enc[:rows], prompt[:rows].clone()
    plen = torch.tensor(plen)
    for i, n in enumerate(plen.tolist()):
        prompt[i, n:] = TW.token_layout(model.config.n_vocab).eot
    ref = JW.beam_decode(jparams, jnp.asarray(enc.numpy()), jnp.asarray(prompt.numpy(), jnp.int32),
                         jnp.asarray(plen.numpy(), jnp.int32), None,
                         JW.get_config(model.config.name), model.config.n_text_head, max_new,
                         beam_size=beam, patience=patience, length_penalty=lp,
                         suppress_blank=sb)
    got = TW.beam_decode(model, enc, prompt, plen, max_new, beam_size=beam, patience=patience,
                         length_penalty=lp, suppress_blank=sb)
    return got, ref


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[:6])))
def test_beam_decode_matches_jax(pair, case):
    got, ref = _run_both(pair, *case)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=SUM_ATOL, rtol=SUM_RTOL)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-5)


def test_rows_finish_at_different_steps(pair):
    """The inputs above do what the parity cases rely on: rows end early and
    at different lengths, at both patiences."""
    for patience in (1.0, 2.0):
        got, _ = _run_both(pair, 2, patience, 1.0, True, 20, 3, (4, 4, 4))
        lengths = got.lengths.tolist()
        assert len(set(lengths)) >= 2 and min(lengths) < 24, lengths


def _states_after(model, enc, prompt, chunk: int, beam: int, candidates: int, max_new: int):
    """A beam state after decoding in chunks of ``chunk`` steps, stopping
    after the first chunk after which the loop's condition fails."""
    dec = model.decoder
    b, p_len = prompt.shape
    st = TW.init_beam_state(model.config, b, beam, candidates, p_len, max_new,
                            torch.float32, torch.device("cpu"))
    ckv = TW.repeat_cross_kv(TW.precompute_cross_kv(dec, enc), beam)
    TW.start_beam(dec, st, prompt, torch.full((b,), p_len), ckv)
    for _ in range(-(-max_new // chunk)):
        TW._beam_chunk(dec, st, ckv, chunk)
        if not bool(TW.beam_running(st)):
            break
    return st


@pytest.mark.parametrize("candidates,max_new", [(2, 20), (2, 12), (4, 20), (4, 12)])
def test_chunks_of_1_and_8_leave_identical_state(pair, candidates, max_new):
    """Steps past the loop's stop change nothing, the cache included: after
    chunks of 8 the state is bit for bit the state where chunks of 1 stop
    (max_new 12: the last chunk of 8 runs 4 steps past T_max)."""
    model, _, enc, prompt = pair
    one = _states_after(model, enc, prompt, 1, 2, candidates, max_new)
    eight = _states_after(model, enc, prompt, 8, 2, candidates, max_new)
    for name, a, b in zip(one._fields, one, eight):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if x is not None:
                assert torch.equal(x, y), name


def test_beam_1_is_the_greedy_decode(pair):
    model, _, enc, prompt = pair
    plen = torch.full((3,), 4)
    beam = TW.beam_decode(model, enc, prompt, plen, 20, beam_size=1)
    greedy = TW.greedy_decode(model, enc, prompt, plen, 20)
    assert torch.equal(beam.tokens, greedy.tokens)
    assert torch.equal(beam.lengths, greedy.lengths)
    torch.testing.assert_close(beam.sum_logprob, greedy.sum_logprob, atol=SUM_ATOL,
                               rtol=SUM_RTOL)
    assert torch.equal(beam.no_speech_prob, greedy.no_speech_prob)


@pytest.mark.parametrize("values", [
    [3.0, -1e9, -1e9, 2.0, -1e9, 3.0, -np.inf, -1e9],
    [0.0, -0.0, 0.0, -np.inf, -np.inf, 1e-30, -1e-30, -0.0],
    [-1e9 - 5.0, -1e9, -1e9 + 64.0, -1e9 - 64.0, -1e9, -1e9 - 5.0, 7.5, 7.5],
])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_breaks_ties_as_lax(values, k):
    x = np.array([values, values[::-1]], np.float32)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), k)
    vals, idx = TW._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("beam,patience,want", [(5, 1.0, 5), (5, 2.0, 10), (2, 1.25, 2),
                                                (2, 1.75, 4), (8, 4.0, 32), (1, 3.0, 3)])
def test_beam_candidates(beam, patience, want):
    assert TW.beam_candidates(beam, patience) == want
