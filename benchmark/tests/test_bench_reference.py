"""The plain reference against cases worked by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import whisper as R


def test_layout_and_prompt_of_both_vocabularies():
    assert R.prompt_of(51865, "en") == [50258, 50259, 50359, 50363]
    # 100 languages in the 51866-token vocabulary shift the task tokens by one
    assert R.prompt_of(51866, "en") == [50258, 50259, 50360, 50364]
    assert R.layout_of(51866).eot == 50257


def test_masks():
    sup = R.suppress_mask(51865, "cpu")
    assert sup[50257] == 0 and torch.isinf(sup[50258]) and torch.isinf(sup[-1])
    assert sup[:50257].eq(0).all()
    beg = R.begin_mask(51865, "cpu")
    assert torch.isinf(beg[220]) and torch.isinf(beg[50257]) and beg[221] == 0


def test_mulaw_roundtrip_by_hand():
    pcm = np.array([0, 32767, -32768, 1024], np.int16)
    got = R.mulaw_roundtrip(pcm)
    # 0 -> code round(127.5) = 128 -> y = 128 / 127.5 - 1 = 1/255 -> (2^(8/255) - 1)/255
    # (float32 arithmetic: y = 128 / 127.5 - 1 is exact to 2e-5 of itself)
    assert got[0] == pytest.approx((2 ** (8 / 255) - 1) / 255, rel=1e-4)
    assert got[1] == pytest.approx(1.0, abs=1e-6)     # code 255
    assert got[2] == pytest.approx(-1.0, abs=1e-6)    # code 0
    x = 1024 / 32768
    code = round((math.log1p(255 * x) / math.log(256) + 1) * 127.5)
    y = code / 127.5 - 1
    assert got[3] == pytest.approx((256 ** y - 1) / 255, rel=1e-5)


def test_served_row_keeps_the_newest_audio_and_pads():
    audio = np.full(3 * 16000, 0.5, np.float32)
    audio[-16000:] = -0.25
    row = R.served_row(audio, 2.0, "int16")
    assert row.shape == (32000,)
    assert row[:16000] == pytest.approx(0.5) and row[16000:] == pytest.approx(-0.25)
    short = R.served_row(audio[:8000], 1.0, "int16")
    assert short[:8000] == pytest.approx(0.5) and (short[8000:] == 0).all()


def test_log_mel_of_silence_is_the_floor():
    mel = R.log_mel(torch.zeros(1, 1600), 80)
    # log10(1e-10) = -10 everywhere, the max - 8 floor above it: (-10 + 4) / 4
    assert mel.shape == (1, 80, 10)
    assert torch.allclose(mel, torch.full_like(mel, -1.5))


def test_attention_and_int8_cross_kv_by_hand():
    # one head of width 4: softmax over two keys, q and k each scaled 4**-0.25
    q = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]])
    k = torch.tensor([[[[2.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]]]) * 4 ** -0.25
    v = torch.tensor([[[[1.0, 2.0, 3.0, 4.0], [-1.0, 0.0, 1.0, 0.0]]]])
    out = R._attend(q, k, v, h=1)
    s = np.array([2.0 / 2.0, 0.0])            # (1 * 2) * 4**-0.5
    w = np.exp(s) / np.exp(s).sum()
    want = w[0] * np.array([1, 2, 3, 4]) + w[1] * np.array([-1, 0, 1, 0])
    assert out[0, 0].numpy() == pytest.approx(want, rel=1e-6)

    dims = R.Dims(1, 2, 1, 0, 8, 2, 1, 1, 4, 4)
    w8 = {"dec.0.xattn.k.w": torch.eye(2), "dec.0.xattn.v.w": torch.eye(2)}
    enc = torch.tensor([[[1.0, -0.5], [0.25, 0.3]]])
    (kq, vq), = R.cross_kv_int8(w8, dims, enc)
    # v: one scale for the (row, head): max |x| = 1 -> 1/127; codes round x * 127
    assert vq[0, 0].numpy() == pytest.approx(np.round(enc[0].numpy() * 127) / 127)
    ks = enc[0].numpy() * 2 ** -0.25
    assert kq[0, 0].numpy() == pytest.approx(np.round(ks / (1 * 2 ** -0.25) * 127)
                                             * (2 ** -0.25 / 127), rel=1e-6)


def test_weights_draw_in_their_fixed_order():
    dims = R.Dims(2, 4, 1, 1, 8, 4, 1, 1, 6, 5)
    w = R.draw_weights(dims, 123, "cpu")
    rng = np.random.default_rng(123)
    first = rng.normal(0.0, (3 * 2) ** -0.5, (3, 2, 4)).astype(np.float32)
    assert np.array_equal(w["enc.conv1.w"].numpy(), first)
    assert list(w)[:4] == ["enc.conv1.w", "enc.conv2.w", "enc.pos", "enc.0.attn.q.w"]
    assert list(w)[-4:] == ["dec.0.xattn.q.w", "dec.0.xattn.k.w", "dec.0.xattn.v.w",
                            "dec.0.xattn.o.w"]
    assert w["enc.pos"][0, :2].tolist() == [0.0, 0.0] and w["enc.pos"][0, 2:].tolist() == [1, 1]
