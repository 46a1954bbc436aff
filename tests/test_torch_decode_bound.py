"""Decode bounds that are not a multiple of the 8-step chunk, against the JAX engine.

``max_decode_tokens`` may be any positive value in the JAX engine
(``stt_tpu/engine/engine.py:1100``; ``max_new_for`` caps each bucket's bound
at it). The port's decode graphs cover such a bound with whole chunks and
a tail of ``max_new % 8`` steps (captured on the card, uncaptured here).
``WhisperEngine("test", device="cpu", compute_type="float32")`` of both
packages, at bounds 12 (every bucket's bound 12: one chunk and a tail of
4) and 100 (the 30 s bucket's 100: 12 chunks and a tail of 4; the 2 s
bucket's 24), serve greedy groups, a beam-3 group and a drafted group (a
perfect, a mutated and an empty draft) on the same seed-0 weights: the
packed token rows, lengths and language indices identical, the logprob sum
within atol 1e-5 plus rtol 1e-5, texts equal, and no row longer than the
bound.
"""

import numpy as np
import pytest

from stt_tpu.engine import engine as JE
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

SUM_ATOL = 1e-5
BOUNDS = (12, 100)
KW = dict(device="cpu", compute_type="float32", audio_buckets_sec=(2.0, 30.0),
          batch_buckets=(1, 4))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


# name -> (rows as (seconds, language, seed), options)
GROUPS = {
    "greedy_30s": ([(25.0, "en", 1), (28.0, None, 2)], {}),
    "greedy_2s": ([(1.5, "en", 3), (1.1, "en", 4), (1.9, None, 5)], {}),
    "beam_30s": ([(26.0, "en", 6), (21.0, "en", 7)], {"beam_size": 3}),
}


def _tasks(module, group, options):
    return [module._Task(module.DecodeRequest(_audio(s, seed), language=lang, options=options),
                         None) for s, lang, seed in group]


def _run(engine, tasks):
    ctx = engine._device_phase(tasks)
    packed = np.array(ctx["packed"]) if not hasattr(ctx["packed"], "numpy") else (
        ctx["packed"].numpy().copy())
    return packed, engine._harvest(ctx)


@pytest.fixture(scope="module", params=BOUNDS)
def served(request):
    bound = request.param
    port = TE.WhisperEngine("test", max_decode_tokens=bound, draft_mode="off", **KW)
    ref = JE.WhisperEngine("test", max_decode_tokens=bound, **KW)
    results = {}
    for name, (group, options) in GROUPS.items():
        results[name] = (_run(port, _tasks(TE, group, options)),
                         _run(ref, _tasks(JE, group, options)))
    # drafted: the plain 30 s decode's own tokens, the same mutated after 3,
    # and an empty draft
    plain = results["greedy_30s"][0][1]
    gen = [o._tokens[o._p_len:o._p_len + o._n_gen].astype(np.int32) for o in plain]
    mutated = gen[1].copy()
    mutated[3:] = (mutated[3:] + 7) % 1000
    drafts = [gen[0], mutated, np.zeros((0,), np.int32)]
    rows = [(25.0, "en", 1), (28.0, "en", 2), (27.0, "en", 8)]
    drafted = []
    for module, engine in ((TE, port), (JE, ref)):
        tasks = _tasks(module, rows, {})
        for task, draft in zip(tasks, drafts):
            task.draft = draft
        drafted.append(_run(engine, tasks))
    results["drafted_30s"] = tuple(drafted)
    yield bound, port, results
    port.close()
    ref.close()


@pytest.mark.parametrize("name", [*GROUPS, "drafted_30s"])
def test_packed_rows_equal_the_jax_engine(served, name):
    bound, _, results = served
    (t_packed, _), (j_packed, _) = results[name]
    assert t_packed.shape == j_packed.shape
    extra = 1 if name.startswith("drafted") else 0   # the accepted-count column
    t_max = t_packed.shape[1] - 5 - extra
    int_cols = list(range(t_max + 1)) + [t_max + 3] + ([t_max + 5] if extra else [])
    np.testing.assert_array_equal(t_packed[:, int_cols], j_packed[:, int_cols])
    np.testing.assert_allclose(t_packed[:, t_max + 1].view(np.float32),
                               j_packed[:, t_max + 1].view(np.float32), atol=SUM_ATOL, rtol=1e-5)


@pytest.mark.parametrize("name", [*GROUPS, "drafted_30s"])
def test_outputs_equal_the_jax_engine_within_the_bound(served, name):
    bound, _, results = served
    (_, t_out), (_, j_out) = results[name]
    for t, j in zip(t_out, j_out):
        assert [s.text for s in t.segments] == [s.text for s in j.segments]
        assert t._n_gen == j._n_gen <= bound


def test_bounds_off_the_chunk_reach_the_tail(served):
    """The 30 s group decodes to the bound, past its last whole chunk."""
    bound, port, results = served
    max_new = port._max_new_for(30.0)
    assert max_new == bound and max_new % TW.FINISH_CHECK_EVERY == 4
    (_, t_out), _ = results["greedy_30s"]
    entry = port.graphs.lookup(30.0, 4, 4, max_new)
    assert (entry.chunks, entry.tail) == (max_new // 8, 4)
    assert max(o._n_gen for o in t_out) > entry.chunks * TW.FINISH_CHECK_EVERY


@pytest.mark.parametrize("max_decode", [12, 20, 100, 101])
def test_max_new_for_matches_the_jax_engine(max_decode):
    for bucket in TE.DEFAULT_AUDIO_BUCKETS_SEC:
        assert TE.max_new_for(bucket, max_decode) == JE.max_new_for(bucket, max_decode)
