"""The port's engine serving beam search against the JAX package's engine.

``accurate`` requests (the shipped profile: beam 5, patience 1) and beam
groups with patience 2, length penalty 0.5 or suppress-blank off go through
``WhisperEngine("test", device="cpu", compute_type="float32")`` of both
packages on the same seed-0 weights, some rows with a fixed language and
some detected (on the rows, before the beams replicate them): token rows,
lengths and language indices of the packed result identical, the logprob
sum within atol 1e-5 plus rtol 1e-5 (as the greedy engine parity holds its
float columns), text, language, average logprob and p(no_speech) equal.
The beam options parse as the JAX engine parses them, the group key keeps
beam policies apart, and the graph cache keys beam entries apart
(``tests/test_torch_graphs.py`` holds ``prewarm(beam_sizes=[1, 5])``).
"""

import numpy as np
import pytest

from stt_tpu.engine import engine as JE
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

SUM_ATOL = 1e-5
ACCURATE = {"beam_size": 5, "best_of": 5, "patience": 1.0, "temperature": 0.0,
            "length_penalty": 1.0, "without_timestamps": True,
            "compression_ratio_threshold": 2.4, "no_speech_threshold": 0.6,
            "log_prob_threshold": -1.0}


@pytest.mark.parametrize("options", [
    {}, {"beam_size": 5}, {"beam_size": "3"}, {"beam_size": 0}, {"beam_size": 20},
    {"beam_size": "x"}, {"patience": 2.1}, {"patience": 0.3}, {"patience": 9},
    {"patience": "bad"}, {"length_penalty": 0.6}, {"length_penalty": 3.0},
    {"length_penalty": None}, {"suppress_blank": False}, {"suppress_blank": 0},
])
def test_beam_options_parse_as_the_reference(options):
    t = TE.DecodeRequest(np.zeros(10, np.float32), options=options)
    j = JE.DecodeRequest(np.zeros(10, np.float32), options=options)
    for name in ("_beam_size_of", "_patience_of", "_length_penalty_of", "_suppress_blank_of"):
        assert getattr(TE, name)(t) == getattr(JE, name)(j), name


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * (180 + 30 * seed) * t) + 0.05 * rng.normal(0, 1, t.shape)
    return sig.astype(np.float32)


# (seconds, language, seed) per group, and the group's options
ENGINE_GROUPS = [
    ([(1.2, "en", 1), (1.9, None, 2), (1.5, "de", 3)], ACCURATE),
    ([(0.6, None, 4)], ACCURATE),
    ([(1.7, "en", 5), (1.1, None, 6)], {**ACCURATE, "patience": 2.0, "length_penalty": 0.5}),
    ([(0.9, "en", 7)], {"beam_size": 3, "suppress_blank": False}),
]


@pytest.fixture(scope="module")
def served():
    port = TE.WhisperEngine("test", device="cpu", compute_type="float32", max_decode_tokens=32)
    ref = JE.WhisperEngine("test", device="cpu", compute_type="float32", max_decode_tokens=32)
    results = []
    for group, options in ENGINE_GROUPS:
        t_tasks = [TE._Task(TE.DecodeRequest(_audio(s, seed), language=lang, options=options),
                            None) for s, lang, seed in group]
        j_tasks = [JE._Task(JE.DecodeRequest(_audio(s, seed), language=lang, options=options),
                            None) for s, lang, seed in group]
        t_ctx = port._device_phase(t_tasks)
        j_ctx = ref._device_phase(j_tasks)
        t_packed = t_ctx["packed"].numpy().copy()
        j_packed = np.array(j_ctx["packed"])
        results.append((t_packed, j_packed, port._harvest(t_ctx), ref._harvest(j_ctx)))
    yield port, results
    port.close()
    ref.close()


@pytest.mark.parametrize("gi", range(len(ENGINE_GROUPS)))
def test_engine_beam_packed_rows_identical(served, gi):
    _, results = served
    t_packed, j_packed, _, _ = results[gi]
    assert t_packed.shape == j_packed.shape
    t_max = t_packed.shape[1] - 5
    int_cols = list(range(t_max + 1)) + [t_max + 3]  # tokens, length, lang idx
    np.testing.assert_array_equal(t_packed[:, int_cols], j_packed[:, int_cols])
    for col, atol in ((t_max + 1, SUM_ATOL), (t_max + 2, 0.0), (t_max + 4, 0.0)):
        np.testing.assert_allclose(t_packed[:, col].view(np.float32),
                                   j_packed[:, col].view(np.float32), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("gi", range(len(ENGINE_GROUPS)))
def test_engine_beam_outputs_identical(served, gi):
    _, results = served
    _, _, t_out, j_out = results[gi]
    assert len(t_out) == len(j_out) == len(ENGINE_GROUPS[gi][0])
    for t, j in zip(t_out, j_out):
        assert [s.text for s in t.segments] == [s.text for s in j.segments]
        assert t.info.language == j.info.language
        assert t._n_gen == j._n_gen
        assert t.avg_logprob == pytest.approx(j.avg_logprob, rel=1e-5)
        assert t.no_speech_prob == pytest.approx(j.no_speech_prob, rel=1e-5)


def test_engine_beam_groups_take_beam_entries(served):
    port, _ = served
    keys = {(k.beam, k.candidates, k.rows) for k in port.graphs._entries}
    assert {(5, 5, 4), (5, 5, 1), (5, 10, 4), (3, 3, 1)} <= keys
    entry = port.graphs.lookup(2.0, 4, 4, port._max_new_for(2.0), 5)
    assert entry.state.tokens.shape == (4, 5, 4 + port._max_new_for(2.0))
    assert entry.cross_kv.k.shape[1] == 20 and entry.state.pool_lp is None
    pooled = port.graphs.lookup(2.0, 4, 4, port._max_new_for(2.0), 5, 10)
    assert pooled.state.pool_lp.shape == (4, 10)


def test_group_key_separates_beam_policies():
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32")

    def key(options):
        return eng._group_key(TE._Task(TE.DecodeRequest(np.zeros(16000, np.float32),
                                                        language="en", options=options), None))

    assert key({}) == key({"beam_size": 1, "patience": 2.0, "length_penalty": 0.5})
    assert len({key({}), key({"beam_size": 5}), key({"beam_size": 5, "patience": 2.0}),
                key({"beam_size": 5, "length_penalty": 0.5}), key({"beam_size": 3})}) == 5
    # best_of joins the fallback policy in the key, as in the JAX engine's
    # (stt_tpu/engine/engine.py:1633-1640): accurate groups with best_of 5 only
    assert key(ACCURATE) == key({"beam_size": 5, "best_of": 5}) != key({"beam_size": 5})


def test_graph_keys_and_entry_reuse_for_beams():
    eng = TE.WhisperEngine("test", device="cpu", compute_type="float32")
    graphs = eng.graphs
    greedy = graphs.entry(1.0, 2, 4, 24, 50)
    beam = graphs.entry(1.0, 2, 4, 24, 50, 5)
    assert graphs.entry(1.0, 2, 4, 24, 50, 5, 5) is beam and beam is not greedy
    assert graphs.key(1.0, 2, 4, 24, 5) == graphs.key(1.0, 2, 4, 24, 5, 3)  # at least the beam
    pooled = graphs.entry(1.0, 2, 4, 24, 50, 5, 10)
    assert len({id(greedy), id(beam), id(pooled)}) == 3 == len(graphs)
    assert isinstance(beam.state, TW.BeamState) and beam.chunk_fn is TW._beam_chunk
    assert greedy.chunk_fn is TW._decode_chunk
    assert beam.cross_kv.k.shape[1] == 10 and greedy.cross_kv.k.shape[1] == 2
    assert pooled.state.pool_tokens.shape == (2, 10, 28)
    with pytest.raises(ValueError, match="beam"):
        graphs.key(1.0, 2, 4, 24, 9)
