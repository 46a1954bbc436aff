"""Narrow operands with float32 accumulation, as the JAX package computes.

The JAX package multiplies bf16 operands with
``preferred_element_type=float32`` in the attention products and the
vocabulary logits. The port does the same on the card through the
``out_dtype`` overloads of ``bmm``/``mm``; on the CPU, which has no kernel
for them, it upcasts and multiplies in float32 (bf16 products are exact in
float32, so the routes differ only in summation order). The route is
chosen by the tensor's device.

Here: float32 still gives the JAX package's tokens exactly (the
conversions are no-ops there); bf16 logits of one decode step, of the
prefill and of language detection stay within 0.05 of JAX's; a bf16 model
holds no float32 copy of its token table; on the CPU no ``out_dtype``
overload is called; and on the meta device, which takes the card's route
with no card, the decode step, the prefill and the logits call
``bmm.dtype``/``mm.dtype`` and make no float32 tensor of the shape of the
self cache, the cross K/V or the token table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as TW
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

BF16_LOGITS_ATOL = 0.05


class _OpLog(TorchDispatchMode):
    """Records every aten op with the dtypes and shapes of its outputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((str(func), [(t.dtype, tuple(t.shape)) for t in outs
                                     if isinstance(t, torch.Tensor)]))
        return out

    def names(self):
        return [name for name, _ in self.ops]

    def float32_shapes(self):
        return {shape for _, outs in self.ops for dtype, shape in outs
                if dtype == torch.float32}


@pytest.fixture(scope="module")
def test_model():
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    mel = np.random.default_rng(5).normal(0, 1, (2, config.n_mels, 200)).astype(np.float32)
    return config, params, mel


def test_float32_tokens_equal_jax_with_a_long_prompt(test_model):
    """float32 compute through prefill and greedy decode: the JAX package's
    tokens and lengths exactly (a 4-token prompt exercises the prefill)."""
    config, params, mel = test_model
    model = TW.build_model(config, params, torch.device("cpu"))
    jparams = JW.init_params(JW.get_config("test"), seed=0)
    enc = np.array(JW.encode(jparams, jnp.asarray(mel), config.n_audio_head))
    prompt = np.array([TW.build_prompt(config, "en"),
                       TW.build_prompt(config, "fr", task="translate")], np.int32)
    plen = np.full((2,), prompt.shape[1], np.int32)
    ref = JW.greedy_decode(jparams, jnp.asarray(enc), jnp.asarray(prompt),
                           jnp.asarray(plen), None, JW.get_config("test"),
                           config.n_text_head, 32)
    got = TW.greedy_decode(model, torch.from_numpy(enc), torch.from_numpy(prompt),
                           torch.from_numpy(plen), 32)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.fixture(scope="module")
def bf16_pair(test_model):
    config, params, mel = test_model
    jparams = JW.init_params(JW.get_config("test"), seed=0, dtype=jnp.bfloat16)
    model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16)
    enc32 = np.asarray(JW.encode(JW.init_params(JW.get_config("test"), seed=0),
                                 jnp.asarray(mel), config.n_audio_head))
    enc_j = jnp.asarray(enc32).astype(jnp.bfloat16)
    enc_t = torch.from_numpy(enc32).to(torch.bfloat16)
    return config, jparams, model, enc_j, enc_t


def test_bf16_teacher_forced_logits_within_bound(bf16_pair):
    """The prefill's products (causal self-attention over the prompt, cross
    attention over the stored K/V, the logits) in bf16: within 0.05 of JAX."""
    config, jparams, model, enc_j, enc_t = bf16_pair
    rng = np.random.default_rng(2)
    prompt = TW.build_prompt(config, "en")
    text = rng.integers(0, config.n_vocab - 1000, (2, 6))
    tokens = np.concatenate([np.tile(prompt, (2, 1)), text], axis=1).astype(np.int32)
    ref = np.asarray(JW.decoder_forward(jparams, jnp.asarray(tokens), enc_j,
                                        config.n_text_head), np.float32)
    got = TW.decoder_forward(model, torch.from_numpy(tokens).long(), enc_t)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < BF16_LOGITS_ATOL


def test_bf16_language_detection_within_bound(bf16_pair):
    config, jparams, model, enc_j, enc_t = bf16_pair
    ref = np.asarray(JW.detect_language(jparams, enc_j, JW.get_config("test"),
                                        config.n_text_head), np.float32)
    got = TW.detect_language(model, enc_t).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < BF16_LOGITS_ATOL


def test_bf16_decoder_holds_no_float32_token_table(bf16_pair):
    config, _, model, _, enc_t = bf16_pair
    b = enc_t.shape[0]
    cache = TW.init_kv_cache(config, b, 8, torch.bfloat16, torch.device("cpu"))
    ckv = TW.precompute_cross_kv(model.decoder, enc_t)
    sot = torch.full((b,), TW.token_layout(config.n_vocab).sot)
    logits = TW._decoder_step(model.decoder, sot, 0, cache, ckv)
    assert logits.dtype == torch.float32
    dec = model.decoder
    assert not hasattr(dec, "tok_f32") and not hasattr(dec, "_tok_f32")
    held = list(dec.state_dict().values()) + [
        v for v in vars(dec).values() if isinstance(v, torch.Tensor)]
    table = [t for t in held if t.shape == (config.n_vocab, config.n_text_state)]
    assert table and all(t.dtype == torch.bfloat16 for t in table)


def test_cpu_takes_the_plain_route(bf16_pair):
    """On the CPU the products upcast and multiply in float32: no
    ``out_dtype`` overload is called (the CPU has no kernel for them)."""
    config, _, model, _, enc_t = bf16_pair
    b = enc_t.shape[0]
    cache = TW.init_kv_cache(config, b, 8, torch.bfloat16, torch.device("cpu"))
    ckv = TW.precompute_cross_kv(model.decoder, enc_t)
    sot = torch.full((b,), TW.token_layout(config.n_vocab).sot)
    with _OpLog() as log:
        TW._decoder_step(model.decoder, sot, 0, cache, ckv)
    names = log.names()
    assert not any(n.startswith(("aten.bmm.dtype", "aten.mm.dtype")) for n in names)
    assert any(n.startswith(("aten.bmm", "aten.mm", "aten.matmul")) for n in names)
    assert not TW._narrow_f32(enc_t)


@pytest.fixture(scope="module")
def meta_model(test_model):
    config, params, _ = test_model
    model = TW.build_model(config, params, torch.device("meta"), torch.bfloat16)
    return config, model


@pytest.mark.parametrize("cross_kv", ["int8", "fp8", "bf16"])
def test_card_route_decode_step_on_meta(meta_model, cross_kv):
    """The decode step on the meta device (the card's route without a
    card): the attention products and the logits take the ``out_dtype``
    overloads, and no float32 tensor of the self cache's, the cross K/V's
    or the token table's shape is made. fp8 K/V are converted to bf16; int8
    K/V are read as codes by the int8-code products (``ops/kernels/
    cross_mm.py``), so the cross products take no overload and no bf16 copy
    of the cross K/V is made."""
    config, model = meta_model
    model.decoder.policy = TW.AttentionPolicy(cross_kv_dtype=cross_kv)
    b, t_max, n_audio = 3, 24, 50
    meta = torch.device("meta")
    enc = torch.empty(b, n_audio, config.n_audio_state, dtype=torch.bfloat16, device=meta)
    cache = TW.init_kv_cache(config, b, t_max, torch.bfloat16, meta)
    ckv = TW.empty_cross_kv(model.decoder, b, n_audio, torch.bfloat16, meta)
    TW.precompute_cross_kv(model.decoder, enc, out=ckv)
    tokens = torch.zeros(b, dtype=torch.long, device=meta)
    pos = torch.zeros((), dtype=torch.long, device=meta)
    with _OpLog() as log:
        logits = TW._decoder_step(model.decoder, tokens, pos, cache, ckv)
    assert logits.dtype == torch.float32 and logits.shape == (b, config.n_vocab)
    names = log.names()
    n_layer = config.n_text_layer
    cross_products = 0 if cross_kv == "int8" else 2
    assert sum(n.startswith("aten.bmm.dtype") for n in names) == (2 + cross_products) * n_layer
    assert sum(n.startswith("aten.mm.dtype") for n in names) == 1
    h, dh = config.n_text_head, config.n_text_state // config.n_text_head
    forbidden = {(b, h, t_max, dh), (b * h, t_max, dh), (b * h, dh, t_max),
                 (b, h, n_audio, dh), (b * h, n_audio, dh), (b * h, dh, n_audio),
                 (config.n_vocab, config.n_text_state),
                 (config.n_text_state, config.n_vocab)}
    assert not log.float32_shapes() & forbidden
    converted = {shape for name, outs in log.ops if name.startswith("aten._to_copy")
                 for dtype, shape in outs if dtype == torch.bfloat16}
    if cross_kv == "fp8":
        assert (b, h, n_audio, dh) in converted
    if cross_kv == "int8":
        assert (b, h, n_audio, dh) not in converted
    model.decoder.policy = TW.AttentionPolicy()


def test_card_route_prefill_and_encoder_on_meta(meta_model):
    """The prefill (causal self-attention, cross attention, the sot logits)
    and the encoder's attention take the ``out_dtype`` overloads too."""
    config, model = meta_model
    b, n_audio, width = 2, 50, 4
    meta = torch.device("meta")
    mel = torch.empty(b, config.n_mels, 2 * n_audio, dtype=torch.bfloat16, device=meta)
    with _OpLog() as enc_log:
        enc = model.encoder(mel)
    assert sum(n.startswith("aten.bmm.dtype") for n in enc_log.names()) == \
        2 * config.n_audio_layer
    cache = TW.init_kv_cache(config, b, 16, torch.bfloat16, meta)
    ckv = TW.precompute_cross_kv(model.decoder, enc)
    tokens = torch.zeros(b, 16, dtype=torch.long, device=meta)
    layout = TW.token_layout(config.n_vocab)
    with _OpLog() as log:
        nsp = TW._prefill(model.decoder, tokens, width + 1, cache, ckv, 0, layout)
    assert nsp.shape == (b,)
    names = log.names()
    assert sum(n.startswith("aten.bmm.dtype") for n in names) == 4 * config.n_text_layer
    assert sum(n.startswith("aten.mm.dtype") for n in names) == 1
    assert (config.n_vocab, config.n_text_state) not in log.float32_shapes()


def test_float32_compute_on_meta_takes_the_float32_products(test_model):
    """Under float32 compute there is nothing to narrow: the plain float32
    products, on any device."""
    config, params, _ = test_model
    model = TW.build_model(config, params, torch.device("meta"), torch.float32)
    b, meta = 2, torch.device("meta")
    enc = torch.empty(b, 50, config.n_audio_state, device=meta)
    cache = TW.init_kv_cache(config, b, 8, torch.float32, meta)
    ckv = TW.precompute_cross_kv(model.decoder, enc)
    with _OpLog() as log:
        TW._decoder_step(model.decoder, torch.zeros(b, dtype=torch.long, device=meta),
                         torch.zeros((), dtype=torch.long, device=meta), cache, ckv)
    assert not any(n.startswith(("aten.bmm.dtype", "aten.mm.dtype")) for n in log.names())


def test_card_route_upcasts_products_that_autograd_records():
    """Training in bf16 on the card: a product whose operand requires grad
    takes the upcast route (the ``out_dtype`` overloads have no
    derivative) and differentiates; without grad, or with no operand
    requiring it, the narrow route stays (serving). Meta tensors stand in
    for the card's."""
    a = torch.empty((2, 4, 8), dtype=torch.bfloat16, device="meta")
    b = torch.empty((2, 8, 3), dtype=torch.bfloat16, device="meta")
    assert TW._narrow_f32(a, b)
    with torch.no_grad():
        assert TW._narrow_f32(a.requires_grad_(True), b)
    assert not TW._narrow_f32(a, b)
    assert not TW._narrow_f32(b.transpose(-1, -2).detach(), a.transpose(-1, -2))
    with _OpLog() as log:
        out = TW._bmm_f32(a, b)
        flat = TW._mm_f32(a[0], b[0])
    assert not any(n.startswith(("aten.bmm.dtype", "aten.mm.dtype")) for n in log.names())
    assert out.dtype == flat.dtype == torch.float32 and out.shape == (2, 4, 3)
    (grad_a,) = torch.autograd.grad(out.sum() + flat.sum(), (a,))
    assert grad_a.shape == a.shape
