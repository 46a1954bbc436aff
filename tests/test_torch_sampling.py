"""Sampling and the temperature-fallback ladder in the port against the JAX
package.

The port draws ``argmax(gumbel + logits / T)`` as ``jax.random.categorical``
does, its Gumbel noise from :func:`stt_tpu_torch.models.whisper.gumbel_noise`
on a ``torch.Generator`` (Philox, not threefry: the bit streams cannot
agree). So the parity tests feed JAX's own draws in: ``JaxDraws`` stands in
for ``gumbel_noise`` and, whenever a sampled decode reseeds its rules, starts
``jax.random.PRNGKey(seed)`` and splits it once a step as ``sample_decode``
does. On the CPU in float32:

- ``sample_decode`` gives the JAX function's tokens and lengths (logprob
  sums within atol 1e-5 plus rtol 1e-6) at several temperatures (0 clamps to
  1e-3), with a penalty and bans, on the eot-prone ``test`` weights (the
  penalised sampled route of the engine's ladder is this one);
- the generator path itself: one seed twice gives one decode, two seeds
  two;
- the ladder's parsers and gate equal the JAX engine's
  (``tests/test_engine.py:215``), and the group key splits on the ladder,
  ``best_of`` and the prompt reset (``:922``);
- the ladder served by ``WhisperEngine("test", device="cpu",
  compute_type="float32")`` equals the JAX engine's outputs (text, segments,
  ``avg_logprob`` within 1e-5, ``temperature_used``, language): every row
  failing the gate (``log_prob_threshold`` 0; two rungs, ``best_of`` 2,
  the best of each row's samples kept; one row's language detected, so
  the retry prompt carries the resolved one, ``:388``), a conditioning
  prompt dropped above ``prompt_reset_on_temperature`` after an impossible
  compression gate (``:871``), a first rung above 0, and a scalar
  temperature (one rung: the primary pass alone).
"""

from functools import partial

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
from tests.test_torch_timestamps import ENGINE_KW, _audio, assert_outputs_equal
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CFG = JW.PRESETS["test"]
SUM_ATOL, SUM_RTOL = 1e-5, 1e-6


@partial(jax.jit, static_argnums=(1, 2))
def _gumbel_chain(seed, steps: int, shape: tuple):
    """``steps`` draws of ``shape`` along ``sample_decode``'s chain: the key
    split once a step, the draw from the split-off key."""
    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.gumbel(sub, shape)

    return jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=steps)[1]


class JaxDraws:
    """``gumbel_noise`` replaced by ``jax.random.gumbel`` along
    ``sample_decode``'s chain of splits from the seed of the latest reset
    (drawn for the decode's whole budget at once)."""

    def __init__(self, mp: pytest.MonkeyPatch) -> None:
        reset = TW.reset_rules
        self.draws = None
        self.seeds = []

        def reset_and_restart(rules, *args, **kwargs):
            reset(rules, *args, **kwargs)
            if rules.temperature is not None:
                self.seeds.append(kwargs["seed"])
                self.draws = iter(np.array(_gumbel_chain(
                    kwargs["seed"], args[0].shape[1] - args[2],
                    (args[0].shape[0], CFG.n_vocab))))

        mp.setattr(TW, "reset_rules", reset_and_restart)
        mp.setattr(TW, "gumbel_noise", self)

    def __call__(self, shape, generator):
        return torch.from_numpy(next(self.draws))


@pytest.fixture(scope="module")
def pair():
    return _eot_prone("test")


@pytest.mark.parametrize("temperature,seed,rp,ngram", [
    (0.7, 3, None, 0), (1.0, 5, [1.3, 1.0, 0.7], 2), (0.0, 1, None, 0),
])
def test_sample_decode_matches_jax_with_its_draws(pair, temperature, seed, rp, ngram):
    model, jparams, enc, prompt = pair
    plen = torch.full((3,), 4)
    with pytest.MonkeyPatch.context() as mp:
        draws = JaxDraws(mp)
        got = TW.sample_decode(model, enc, prompt, plen, 20, temperature=temperature, seed=seed,
                               rep_penalty=None if rp is None else torch.tensor(rp),
                               ngram_n=ngram)
    assert draws.seeds == [seed]
    ref = JW.sample_decode(jparams, jnp.asarray(enc.numpy()), jnp.asarray(prompt.numpy()),
                           jnp.asarray(plen.numpy()), None, CFG, CFG.n_text_head, 20,
                           temperature=jnp.float32(temperature), rng=jax.random.PRNGKey(seed),
                           rep_penalty=None if rp is None else jnp.asarray(rp, jnp.float32),
                           ngram_n=ngram)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=SUM_ATOL, rtol=SUM_RTOL)


def test_sampling_leaves_the_greedy_path(pair):
    """The draws above matter: at temperature 1 the tokens leave the
    greedy path."""
    model, _, enc, prompt = pair
    plen = torch.full((3,), 4)
    greedy = TW.greedy_decode(model, enc, prompt, plen, 8)
    sampled = TW.sample_decode(model, enc, prompt, plen, 8, temperature=1.0, seed=7)
    assert not torch.equal(greedy.tokens, sampled.tokens)


def test_generator_seeds(pair):
    """The port's own draws: one seed twice gives one decode, two seeds
    two; the noise is standard Gumbel (mean near Euler's 0.5772)."""
    model, _, enc, prompt = pair
    plen = torch.full((3,), 4)
    runs = [TW.sample_decode(model, enc, prompt, plen, 8, temperature=1.0, seed=s).tokens
            for s in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    gen = torch.Generator().manual_seed(0)
    noise = TW.gumbel_noise((50, 5000), gen)
    assert noise.dtype == torch.float32 and torch.isfinite(noise).all()
    assert abs(float(noise.mean()) - 0.5772) < 0.01


@pytest.mark.parametrize("options", [
    {}, {"temperature": 0.0}, {"temperature": [0.0, 0.5]}, {"temperature": (0.2, 0.4, 0.6)},
    {"temperature": []}, {"temperature": "bogus"}, {"temperature": 0.7},
    {"best_of": 3}, {"best_of": 9}, {"best_of": "x"},
    {"prompt_reset_on_temperature": 0.2}, {"prompt_reset_on_temperature": None},
    {"prompt_reset_on_temperature": "x"},
])
def test_ladder_options_parse_as_the_reference(options):
    t_req = TE.DecodeRequest(np.zeros(10, np.float32), options=options)
    j_req = JE.DecodeRequest(np.zeros(10, np.float32), options=options)
    assert TE._temperature_ladder(options) == JE._temperature_ladder(options)
    assert TE._best_of_of(t_req) == JE._best_of_of(j_req)
    assert TE._reset_temp_of(t_req) == JE._reset_temp_of(j_req)


@pytest.mark.parametrize("text,avg_lp,options", [
    ("a a a a a a a a a a a a a a a a a a a a", -0.1, {"compression_ratio_threshold": 1.5}),
    ("fine text", -5.0, {}), ("fine text", -0.1, {}), ("", -0.1, {"log_prob_threshold": None}),
    ("x y", -0.5, {"logprob_threshold": -0.2}), ("x y", -0.5, {"log_prob_threshold": None,
                                                               "compression_ratio_threshold": None}),
])
def test_fallback_gate_equals_the_reference(text, avg_lp, options):
    assert TE._needs_fallback(text, avg_lp, options) == JE._needs_fallback(text, avg_lp, options)
    assert TW.compression_ratio(text) == JW.compression_ratio(text)


def test_group_key_splits_on_fallback_policy():
    """``tests/test_engine.py:922`` on the port."""
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32")

    def key(opts, seconds=0.8):
        return eng._group_key(TE._Task(TE.DecodeRequest(_audio(seconds, 1), language="en",
                                                        options=opts), None))
    base = key({"temperature": [0.0, 0.5]})
    assert key({"temperature": [0.0, 0.5]}) == base
    assert key({"temperature": [0.0, 0.7]}) != base
    assert key({"temperature": [0.0, 0.5], "best_of": 3}) != base
    assert key({"temperature": [0.0, 0.5], "prompt_reset_on_temperature": 0.2}) != base
    assert key({}, 1.8) != key({}, 0.5)
    eng.close()


LADDER_CASES = {
    "all-fail": {"temperature": [0.0, 0.2, 0.4], "best_of": 2, "log_prob_threshold": 0.0},
    "prompt-reset": {"initial_prompt": "steering context words", "temperature": [0.0, 0.8],
                     "prompt_reset_on_temperature": 0.5, "compression_ratio_threshold": -1.0,
                     "log_prob_threshold": None},
    "first-rung-hot": {"temperature": [0.5, 1.0], "log_prob_threshold": 0.0},
    "scalar": {"temperature": 0.7},
}


@pytest.fixture(scope="module")
def engines():
    port, ref = TE.WhisperEngine("test", **ENGINE_KW), JE.WhisperEngine("test", **ENGINE_KW)
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_equals_the_jax_engine(engines, case):
    port, ref = engines
    options = LADDER_CASES[case]
    # the second row's language is detected: the retry prompt carries the
    # resolved one (tests/test_engine.py:388)
    group = [(1.2, "en", 13), (1.9, None, 2), (0.7, "en", 3)]
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        draws = JaxDraws(mp)
        for module, eng in ((TE, port), (JE, ref)):
            tasks = [module._Task(module.DecodeRequest(_audio(s, seed), language=lang,
                                                       options=dict(options)), None)
                     for s, lang, seed in group]
            outs.append(eng._harvest(eng._device_phase(tasks)))
    t_out, j_out = outs
    assert_outputs_equal(t_out, j_out)
    ladder = TE._temperature_ladder(options)
    if len(ladder) > 1:
        # every case forces the rows through the ladder's rungs
        assert all(o.temperature_used > 0 for o in t_out)
        assert draws.seeds and draws.seeds[0] == 1
    else:
        assert not draws.seeds and all(o.temperature_used == 0.0 for o in t_out)
