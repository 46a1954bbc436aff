"""The port's log-mel front end against the JAX package's.

The plain PyTorch log-mel (the CPU path, and the reference the CUDA kernel
is held to on the card) must match ``stt_tpu.ops.mel.log_mel_spectrogram``
and the Pallas kernel in interpret mode at the tolerance of
``tests/test_pallas_mel.py`` (atol 2e-4, rtol 1e-4): both sides compute
in float32 and differ only in summation order. The wire expansion and
the front end as the engine runs it (wire rows -> log-mel -> encoder) are
held to the JAX engine's ``_mel_encode``. The CUDA kernel itself is held
to the plain version in ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stt_tpu.engine import engine as JE
from stt_tpu.models import whisper as JW
from stt_tpu.ops import mel as jmel
from stt_tpu.ops.pallas.mel import log_mel_spectrogram_pallas
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from stt_tpu_torch.ops import mel as tmel
from stt_tpu_torch.ops.kernels.mel import mel_logspec

ATOL, RTOL = 2e-4, 1e-4


def _audio(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    rows = [
        0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t) + 0.05 * rng.normal(0, 1, t.shape)
        for i in range(batch)
    ]
    return np.stack(rows).astype(np.float32)


def _jax_reference(kind, audio):
    if kind == "xla":
        return np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio)))
    return np.asarray(log_mel_spectrogram_pallas(jnp.asarray(audio), interpret=True))


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("seconds", [1.0, 5.0])
@pytest.mark.parametrize("batch", [1, 3])
def test_plain_log_mel_matches_jax(reference, batch, seconds):
    audio = _audio(batch, seconds)
    ref = _jax_reference(reference, audio)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (batch, 80, int(seconds * 100))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_log_mel_silence(reference):
    audio = np.zeros((1, 16000), np.float32)
    ref = _jax_reference(reference, audio)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_log_mel_non_tile_multiple_frames(reference):
    # 1.5 s = 150 frames: a multiple of neither the Pallas tile (128) nor
    # the CUDA kernel's (32)
    audio = _audio(2, 1.5)
    ref = _jax_reference(reference, audio)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, 80, 150)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rows = torch.from_numpy(_audio(2, 1.0))
    before = mel_logspec.launches
    got = mel_logspec(rows)
    assert mel_logspec.launches == before
    ref = tmel.log_mel_raw(rows)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(
        tmel.normalize_log_mel(got).numpy(),
        _jax_reference("xla", rows.numpy()), atol=ATOL, rtol=RTOL,
    )


@pytest.mark.parametrize("fn", [tmel.log_mel_spectrogram, mel_logspec])
def test_rejects_non_hop_multiple(fn):
    audio = torch.zeros((1, tmel.HOP_LENGTH * 10 + 7))
    with pytest.raises(ValueError):
        fn(audio)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_constants_equal_the_jax_package(n_mels):
    assert np.array_equal(tmel.mel_filterbank(n_mels), jmel.mel_filterbank(n_mels))
    assert np.array_equal(tmel._dft_basis(), jmel._dft_basis())
    assert tmel.mel_filterbank(n_mels).dtype == np.float32


def _jax_expand(rows):
    """``stt_tpu/engine/engine.py:397-402``, the wire expansion inside the
    JAX engine's ``_mel_encode``, restated on a jnp array."""
    rows = jnp.asarray(rows)
    if rows.dtype == jnp.uint8:
        y = rows.astype(jnp.float32) * (1.0 / 127.5) - 1.0
        return jnp.sign(y) * (jnp.exp2(8.0 * jnp.abs(y)) - 1.0) * (1.0 / 255.0)
    return rows.astype(jnp.float32) * (1.0 / 32768.0)


@pytest.mark.parametrize("wire", ["mulaw", "int16"])
def test_wire_expansion_matches_jax(wire):
    if wire == "mulaw":
        rows = np.arange(256, dtype=np.uint8)[None]
    else:
        rows = np.arange(-32768, 32768, 7, dtype=np.int16)[None]
    ref = np.asarray(_jax_expand(rows))
    got = tmel.expand_wire(torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=1e-6)


def test_mulaw_table_and_roundtrip_match_the_jax_engine():
    assert np.array_equal(TE._build_mulaw_lut(), JE._build_mulaw_lut())
    pcm = np.arange(-32768, 32768, dtype=np.int16)
    codes = TE._encode_wire_rows(pcm)
    back = tmel.expand_wire(torch.from_numpy(codes)).numpy()
    # mu-law keeps ~1/128 relative error at speech levels
    err = np.abs(back - pcm / 32768.0)
    assert err.max() < 0.035 and np.median(err) < 0.01


@pytest.fixture(scope="module")
def test_model():
    config = TW.get_config("test")
    params = TW.init_params(config, seed=0)
    return (TW.build_model(config, params, torch.device("cpu")),
            JW.init_params(JW.get_config("test"), seed=0))


@pytest.mark.parametrize("wire", ["mulaw", "int16", "float32"])
def test_mel_encode_matches_the_jax_engine(test_model, wire):
    """Wire rows -> log-mel -> encoder, as each engine runs it."""
    model, jparams = test_model
    audio = _audio(2, 1.0, seed=3)
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    rows = {"mulaw": JE._build_mulaw_lut()[pcm.view(np.uint16)],
            "int16": pcm, "float32": audio}[wire]
    ref = np.asarray(JE._mel_encode(jparams, jnp.asarray(rows), 2, 80, jnp.float32))
    got = TE._mel_encode(model, torch.from_numpy(rows), torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
