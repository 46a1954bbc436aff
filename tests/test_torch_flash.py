"""The port's encoder flash-attention route against the JAX package's, on the CPU.

The JAX package's flash path is a Pallas TPU kernel that cannot run on the
CPU, so the reference is its own plain path: ``_attention`` with
``FLASH_ATTENTION`` off. The port's ``_attention`` with flash on sends the
same inputs through the ``flash_attention`` wrapper, which takes its plain
version on a CPU tensor. Tolerances, set from the size of the outputs
(~0.05 on average, 0.66 at most here): atol 2e-3 and rtol 1e-2 in bf16
(the two frameworks round the scaled q and k and the softmax weights at
different places, so an output may differ by one bf16 step, < 0.8% of
|x|), 1e-5 in float32 (summation order only). The routing tests pin when the flash route is
taken: never with the option off, never below 512 positions or with a
mask, and on a CPU tensor without a kernel launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as TW
from stt_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain

TOLS = {"bfloat16": (2e-3, 1e-2), "float32": (1e-5, 1e-5)}  # (atol, rtol)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts calls of the flash wrapper from the model code."""
    calls = []

    def spy(qh, kh, vh):
        calls.append(tuple(qh.shape))
        return flash_attention(qh, kh, vh)

    monkeypatch.setattr(TW, "flash_attention", spy)
    return calls


def _qkv(b=2, t=600, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_route_matches_jax_attention(monkeypatch, flash_calls, dtype):
    q, k, v = _qkv()
    n_head = 4
    monkeypatch.setattr(JW, "FLASH_ATTENTION", "off")
    jdt = getattr(jnp, dtype)
    ref = np.asarray(JW._attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), n_head),
                     np.float32)
    tdt = getattr(torch, dtype)
    before = flash_attention.launches
    got = TW._attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), n_head, flash=True)
    assert flash_calls == [(2, n_head, 600, 16)]
    assert flash_attention.launches == before  # the CPU takes the plain version
    assert got.dtype == tdt and got.shape == (2, 600, 64)
    atol, rtol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=rtol)


def test_flash_plain_is_unmasked_attn_cached():
    rng = np.random.default_rng(1)
    qh, kh, vh = (torch.from_numpy(rng.normal(0, 1, (1, 2, 530, 32)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(3))
    got = flash_attention(qh, kh, vh)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, TW._attn_cached(qh, kh, vh).to(torch.bfloat16),
                               atol=0, rtol=0)
    torch.testing.assert_close(got, flash_attention_plain(qh, kh, vh), atol=0, rtol=0)


def test_routing_off_and_short(flash_calls):
    off = TW.AttentionPolicy(flash_attention="off")
    auto = TW.AttentionPolicy(flash_attention="auto")
    assert not off.flash_on(4096)
    assert not auto.flash_on(100) and not auto.flash_on(511)
    assert auto.flash_on(512) and auto.flash_on(1500)
    q, k, v = (torch.from_numpy(x) for x in _qkv(b=1, t=600))
    TW._attention(q, k, v, 4, flash=False)
    mask = torch.zeros((600, 600))
    TW._attention(q, k, v, 4, mask=mask, flash=True)  # masked: never flash
    TW._attention(q[:, :10], k, v, 4, flash=True)      # Tq != Tk: never flash
    assert flash_calls == []


@pytest.mark.parametrize("frames,routed", [(100, False), (1000, False), (3000, True)])
def test_encoder_routes_only_the_30s_bucket(flash_calls, frames, routed):
    """The encoder runs at frames // 2 positions: of the 1/2/5/10/30 s
    buckets (50/100/250/500/1500 positions) only 30 s reaches 512."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16,
                           TW.AttentionPolicy(flash_attention="auto"))
    mel = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 80, frames))
                           .astype(np.float32)).to(torch.bfloat16)
    before = flash_attention.launches
    out = model.encoder(mel)
    assert out.shape == (1, frames // 2, config.n_audio_state)
    assert len(flash_calls) == (config.n_audio_layer if routed else 0)
    assert flash_attention.launches == before


def test_encoder_30s_matches_jax_in_bf16(flash_calls):
    """The test model's encoder at a 30 s window (1500 positions) in bf16,
    flash route on, against the JAX encoder (its CPU path is the einsum).
    The bound is the bf16 one of tests/test_torch_whisper.py (0.05) plus
    2% of the value: the layer-normed output reaches |x| ~ 5, where one bf16
    step is 0.03 and the two frameworks' roundings differ by up to two
    steps (0.0625 measured)."""
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    model = TW.build_model(config, params, torch.device("cpu"), torch.bfloat16,
                           TW.AttentionPolicy(flash_attention="auto"))
    jparams = JW.init_params(JW.get_config("test"), seed=0, dtype=jnp.bfloat16)
    mel = np.random.default_rng(3).normal(0, 1, (1, 80, 3000)).astype(np.float32)
    ref = np.asarray(JW.encode(jparams, jnp.asarray(mel).astype(jnp.bfloat16),
                               config.n_audio_head), np.float32)
    assert jax.default_backend() == "cpu"
    got = model.encoder(torch.from_numpy(mel).to(torch.bfloat16)).float().numpy()
    assert len(flash_calls) == config.n_audio_layer
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=2e-2)
