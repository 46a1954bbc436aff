"""SRT / WebVTT subtitle rendering from final transcript segments.

Own copy of ``stt_tpu/utils/subtitles.py`` for the port, which imports nothing of ``stt_tpu``.

The reference surfaces segment times only through a browser overlay UI
(the reference's ``examples/ui/subtitles.html``); this exporter turns the
same ``STTResult`` stream (``proto/stt.proto`` ``start_sec``/``end_sec``/
``text``) into standard subtitle files so batch transcriptions are
directly usable in players and editors. Pure string formatting — no
device or network dependencies.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Cue = Tuple[float, float, str]

# Subtitle cues must span a visible interval; a zero-length cue is
# dropped by some players, so degenerate segments get this floor.
MIN_CUE_SEC = 0.001


def _format_timestamp(seconds: float, decimal_sep: str) -> str:
    """``HH:MM:SS<sep>mmm`` with millisecond rounding and no negatives."""
    total_ms = max(int(round(max(seconds, 0.0) * 1000.0)), 0)
    ms = total_ms % 1000
    total_s = total_ms // 1000
    s = total_s % 60
    m = (total_s // 60) % 60
    h = total_s // 3600
    return f"{h:02d}:{m:02d}:{s:02d}{decimal_sep}{ms:03d}"


def _normalized(cues: Iterable[Cue]) -> List[Cue]:
    """Drop empty-text cues; clamp negative starts and inverted ends."""
    out: List[Cue] = []
    for start, end, text in cues:
        text = (text or "").strip()
        if not text:
            continue
        start = max(float(start), 0.0)
        end = max(float(end), start + MIN_CUE_SEC)
        out.append((start, end, text))
    return out


def render_srt(cues: Iterable[Cue]) -> str:
    """SubRip: 1-based index, ``HH:MM:SS,mmm --> HH:MM:SS,mmm``, text."""
    blocks = []
    for i, (start, end, text) in enumerate(_normalized(cues), start=1):
        blocks.append(
            f"{i}\n"
            f"{_format_timestamp(start, ',')} --> "
            f"{_format_timestamp(end, ',')}\n"
            f"{text}\n"
        )
    return "\n".join(blocks)


def render_vtt(cues: Iterable[Cue]) -> str:
    """WebVTT: ``WEBVTT`` header then ``HH:MM:SS.mmm`` cue blocks."""
    blocks = ["WEBVTT\n"]
    for start, end, text in _normalized(cues):
        blocks.append(
            f"{_format_timestamp(start, '.')} --> "
            f"{_format_timestamp(end, '.')}\n"
            f"{text}\n"
        )
    return "\n".join(blocks)


def cues_from_results(results: Sequence) -> List[Cue]:
    """Extract subtitle cues from a stream of ``STTResult`` messages.

    Only FINAL results become cues (partials are progressive rewrites of
    the same audio, not distinct segments). Empty finals (e.g. the
    end-of-stream flush of a silent tail) are dropped by ``_normalized``.
    """
    return _normalized(
        (r.start_sec, r.end_sec, r.text) for r in results if r.is_final
    )


__all__ = [
    "Cue",
    "MIN_CUE_SEC",
    "cues_from_results",
    "render_srt",
    "render_vtt",
]
