"""The port's Whisper model against the JAX package's, on identical weights.

On the ``test`` and ``tiny`` presets in float32 on the CPU: the port's
``init_params`` draws the JAX package's weights bit for bit, the
conversion round-trips, the encoder and teacher-forced decoder logits
agree within 1e-4 max abs (both float32, differing in summation order),
and greedy decoding gives the same tokens and lengths. The float outputs
of the decode (p(no_speech), the logprob sum) come out of different
softmax implementations and are held at rtol 1e-5.

Under bfloat16 with the int8 cross K/V the two frameworks round at
different places (the JAX package multiplies by the d_head**-0.25 scale
in bfloat16, PyTorch in float32 before rounding, and the products before
the bias add round differently), so token identity is not asked for
(greedy argmax near-ties flip). One decoder step's logits are held to a
tolerance measured on these models: the max abs difference was 0.004 on
``test`` and 0.014 on ``tiny``, against logits up to 0.7 and 1.8 in
magnitude; the bound below is 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch import convert
from stt_tpu_torch.models import whisper as TW

BF16_LOGITS_ATOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a module's torch work (port test modules
    import this fixture). Their models are tiny, so more threads gain
    nothing, and with the suite's six workers on one 8-core host each
    worker's threads spend most of their time waiting at barriers: two
    ``tests/test_torch_graphs.py`` cases in six processes at once took
    459 s at 8 threads and 12 s at 1."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["test", "tiny"])
def pair(request):
    name = request.param
    config = TW.get_config(name)
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, torch.device("cpu"))
    jparams = JW.init_params(JW.get_config(name), seed=0)
    rng = np.random.default_rng(7)
    mel = rng.normal(0, 1, (2, config.n_mels, 200)).astype(np.float32)
    enc = np.array(JW.encode(jparams, jnp.asarray(mel), config.n_audio_head))
    return name, config, params, model, jparams, mel, enc


def test_init_params_bit_identical(pair):
    _, _, params, _, jparams, _, _ = pair
    jtree = _numpy_tree(jparams)
    flat_t = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        assert a.dtype == b.dtype == np.float32, path
        assert np.array_equal(a, b), path


def test_convert_round_trips(pair):
    _, _, params, model, _, _, _ = pair
    sd = convert.from_jax_params(params)
    assert set(sd) == set(model.state_dict())
    back = convert.to_jax_params(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, params))
    again = convert.from_jax_params(convert.to_jax_params(model.state_dict()))
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())


def test_encoder_matches(pair):
    _, _, _, model, _, mel, enc = pair
    got = model.encoder(torch.from_numpy(mel)).numpy()
    assert got.shape == enc.shape == (2, 100, model.config.n_audio_state)
    assert np.abs(got - enc).max() < 1e-4


def test_teacher_forced_logits_match(pair):
    _, config, _, model, jparams, _, enc = pair
    rng = np.random.default_rng(1)
    prompt = TW.build_prompt(config, "en")
    text = rng.integers(0, 50000, (2, 12))
    tokens = np.concatenate([np.tile(prompt, (2, 1)), text], axis=1).astype(np.int32)
    ref = np.asarray(JW.decoder_forward(jparams, jnp.asarray(tokens),
                                        jnp.asarray(enc), config.n_text_head))
    got = TW.decoder_forward(model, torch.from_numpy(tokens).long(),
                             torch.from_numpy(enc)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4


def test_greedy_decode_matches(pair):
    _, config, _, model, jparams, _, enc = pair
    prompt = np.array([TW.build_prompt(config, "en"),
                       TW.build_prompt(config, "de", task="translate")], np.int32)
    plen = np.full((2,), prompt.shape[1], np.int32)
    ref = JW.greedy_decode(jparams, jnp.asarray(enc), jnp.asarray(prompt),
                           jnp.asarray(plen), None, JW.get_config(config.name),
                           config.n_text_head, 24)
    got = TW.greedy_decode(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                           torch.from_numpy(plen), 24)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), rtol=1e-5)
    np.testing.assert_allclose(got.sum_logprob.numpy(),
                               np.asarray(ref.sum_logprob), rtol=1e-5)


def test_detect_language_same_argmax(pair):
    _, config, _, model, jparams, _, enc = pair
    ref = np.asarray(JW.detect_language(jparams, jnp.asarray(enc),
                                        JW.get_config(config.name), config.n_text_head))
    got = TW.detect_language(model, torch.from_numpy(enc)).numpy()
    assert got.shape == ref.shape == (2, 99)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(got - ref).max() < 1e-5


def test_bf16_int8_cross_kv_decoder_step(pair):
    _, config, params, _, _, _, enc = pair
    jparams = JW.init_params(JW.get_config(config.name), seed=0, dtype=jnp.bfloat16)
    model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16)
    enc_j = jnp.asarray(enc).astype(jnp.bfloat16)
    enc_t = torch.from_numpy(enc).to(torch.bfloat16)
    assert np.array_equal(np.asarray(enc_j.astype(jnp.float32)), enc_t.float().numpy())

    ckv_j = JW.precompute_cross_kv(jparams, enc_j, config.n_text_head)
    ckv_t = TW.precompute_cross_kv(model.decoder, enc_t)
    assert ckv_j.k.dtype == jnp.int8 and ckv_t.k.dtype == torch.int8
    # the int8 codes may differ by one step where the bf16 projections round
    # differently; the scales agree closely
    assert np.abs(ckv_t.k.int().numpy() - np.asarray(ckv_j.k, np.int32)).max() <= 2
    np.testing.assert_allclose(ckv_t.k_scale.numpy(), np.asarray(ckv_j.k_scale),
                               rtol=2e-2)

    b = enc.shape[0]
    tok = TW.token_layout(config.n_vocab).sot
    cache_j = JW.init_kv_cache(JW.get_config(config.name), b, 4, dtype=jnp.bfloat16)
    ref, _ = JW._decoder_step(jparams, jnp.full((b,), tok, jnp.int32), 0, cache_j,
                              ckv_j, config.n_text_head, 0)
    cache_t = TW.init_kv_cache(config, b, 4, torch.bfloat16, torch.device("cpu"))
    got = TW._decoder_step(model.decoder, torch.full((b,), tok), 0, cache_t, ckv_t)
    assert got.dtype == torch.float32
    ref = np.asarray(ref, np.float32)
    assert np.abs(got.numpy() - ref).max() < BF16_LOGITS_ATOL


@pytest.mark.parametrize("mode", ["fp8", "bf16"])
def test_bf16_cross_kv_storage_decoder_step(pair, monkeypatch, mode):
    """fp8 and bf16 cross K/V storage with the cross-attention kernel route
    on (its plain version on the CPU): one decoder step's logits against the
    JAX package under the same ``STT_CROSS_KV_DTYPE``, within the bf16 bound."""
    _, config, params, _, _, _, enc = pair
    jparams = JW.init_params(JW.get_config(config.name), seed=0, dtype=jnp.bfloat16)
    monkeypatch.setattr(JW, "CROSS_KV_DTYPE", mode)
    calls = []
    real = TW.xattn_decode
    monkeypatch.setattr(TW, "xattn_decode", lambda *a: calls.append(1) or real(*a))
    policy = TW.AttentionPolicy(cross_kv_dtype=mode, xattn_kernel="mm")
    model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16, policy)
    enc_j = jnp.asarray(enc).astype(jnp.bfloat16)
    enc_t = torch.from_numpy(enc).to(torch.bfloat16)

    ckv_j = JW.precompute_cross_kv(jparams, enc_j, config.n_text_head)
    ckv_t = TW.precompute_cross_kv(model.decoder, enc_t)
    store = {"fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
             "bf16": (jnp.bfloat16, torch.bfloat16)}[mode]
    assert (ckv_j.k.dtype, ckv_t.k.dtype) == store and ckv_t.k_scale is None
    # stored values may differ by one storage step (e4m3: 1/8 relative) where
    # the two frameworks' bf16 projections round differently
    np.testing.assert_allclose(ckv_t.k.float().numpy(), np.asarray(ckv_j.k, np.float32),
                               atol=0.05, rtol=0.125)

    b = enc.shape[0]
    tok = TW.token_layout(config.n_vocab).sot
    cache_j = JW.init_kv_cache(JW.get_config(config.name), b, 4, dtype=jnp.bfloat16)
    ref, _ = JW._decoder_step(jparams, jnp.full((b,), tok, jnp.int32), 0, cache_j,
                              ckv_j, config.n_text_head, 0)
    cache_t = TW.init_kv_cache(config, b, 4, torch.bfloat16, torch.device("cpu"))
    got = TW._decoder_step(model.decoder, torch.full((b,), tok), 0, cache_t, ckv_t)
    assert len(calls) == config.n_text_layer
    assert np.abs(got.numpy() - np.asarray(ref, np.float32)).max() < BF16_LOGITS_ATOL


@pytest.mark.parametrize("xattn_kernel", ["off", "mm"])
def test_cross_kv_storages_token_identical(xattn_kernel):
    """bf16, fp8 and int8 cross K/V give the same greedy tokens on the test
    model, as tests/test_engine.py::test_quantized_cross_kv_transcript_parity
    asserts for the JAX package; with the kernel route on and off."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    mel = np.random.default_rng(3).normal(0, 1, (2, config.n_mels, 100)).astype(np.float32)
    prompt = torch.tensor(np.tile(TW.build_prompt(config, "en"), (2, 1)))
    plen = torch.full((2,), prompt.shape[1])
    outs = {}
    for mode in ("bf16", "fp8", "int8"):
        policy = TW.AttentionPolicy(cross_kv_dtype=mode, xattn_kernel=xattn_kernel)
        model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16, policy)
        enc = model.encoder(torch.from_numpy(mel).to(torch.bfloat16))
        outs[mode] = TW.greedy_decode(model, enc, prompt, plen, 16).tokens
    assert torch.equal(outs["bf16"], outs["fp8"])
    assert torch.equal(outs["bf16"], outs["int8"])
