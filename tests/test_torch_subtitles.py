"""The port's SRT/WebVTT exporter held to the JAX package's.

Every case of ``tests/test_subtitles.py`` runs on both packages'
``utils/subtitles.py`` (``stt_tpu`` and its copy in ``stt_tpu_torch``),
and the two render the same text for the same cues.
"""

import importlib

import pytest

from stt_tpu.gen import stt_pb2 as JPB
from stt_tpu_torch.gen import stt_pb2 as TPB

PACKAGES = ("stt_tpu", "stt_tpu_torch")
PB = {"stt_tpu": JPB, "stt_tpu_torch": TPB}

CUES = [
    [(0.0, 1.5, "hello"), (2.25, 4.0, "world")],
    [(0.5, 1.0, "hi")],
    [(3723.9996, 7325.0011, "x")],
    [(0, 1, "a"), (1, 2, "   "), (2, 3, "b")],
    [(-0.5, -1.0, "neg"), (2.0, 1.0, "inv")],
    [(0, 1, "こんにちは、世界。")],
]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def _subs(pkg):
    return importlib.import_module(f"{pkg}.utils.subtitles")


def test_srt_block_layout(pkg):
    out = _subs(pkg).render_srt([(0.0, 1.5, "hello"), (2.25, 4.0, "world")])
    assert out == (
        "1\n00:00:00,000 --> 00:00:01,500\nhello\n"
        "\n"
        "2\n00:00:02,250 --> 00:00:04,000\nworld\n"
    )


def test_vtt_header_and_dot_separator(pkg):
    out = _subs(pkg).render_vtt([(0.5, 1.0, "hi")])
    assert out.startswith("WEBVTT\n")
    assert "00:00:00.500 --> 00:00:01.000\nhi\n" in out


def test_timestamp_hours_and_ms_rounding(pkg):
    out = _subs(pkg).render_srt([(3723.9996, 7325.0011, "x")])
    assert "01:02:04,000 --> 02:02:05,001" in out


def test_empty_text_cues_dropped_and_numbering_stays_dense(pkg):
    out = _subs(pkg).render_srt([(0, 1, "a"), (1, 2, "   "), (2, 3, "b")])
    assert "1\n" in out and "2\n00:00:02,000" in out
    assert "3\n" not in out


def test_degenerate_and_negative_times_clamped(pkg):
    subs = _subs(pkg)
    out = subs.render_srt([(-0.5, -1.0, "neg"), (2.0, 1.0, "inv")])
    assert out.splitlines()[1].startswith("00:00:00,000 --> 00:00:00,")
    assert "00:00:02,000 --> 00:00:02,001" in out
    assert subs.MIN_CUE_SEC > 0


def _results(pb):
    return [
        pb.STTResult(text="part", is_final=False, start_sec=0, end_sec=1),
        pb.STTResult(text="final one", is_final=True, start_sec=0, end_sec=1.2),
        pb.STTResult(text="", is_final=True, start_sec=1.2, end_sec=1.3),
        pb.STTResult(text="final two", is_final=True, start_sec=1.5, end_sec=2.0),
    ]


def test_cues_from_results_keeps_finals_only(pkg):
    cues = _subs(pkg).cues_from_results(_results(PB[pkg]))
    assert [c[2] for c in cues] == ["final one", "final two"]
    assert cues[0][:2] == (0.0, 1.2)


def test_unicode_text_roundtrip(pkg):
    out = _subs(pkg).render_vtt([(0, 1, "こんにちは、世界。")])
    assert "こんにちは、世界。" in out


@pytest.mark.parametrize("cues", CUES, ids=range(len(CUES)))
@pytest.mark.parametrize("render", ["render_srt", "render_vtt"])
def test_port_renders_the_jax_text(cues, render):
    jax_subs, port_subs = _subs("stt_tpu"), _subs("stt_tpu_torch")
    assert getattr(port_subs, render)(cues) == getattr(jax_subs, render)(cues)
    assert port_subs.MIN_CUE_SEC == jax_subs.MIN_CUE_SEC
    assert (port_subs.cues_from_results(_results(TPB))
            == jax_subs.cues_from_results(_results(JPB)))
