"""Whisper model-family table and token-layout derivations — pure data.

Own copy of ``stt_tpu/models/presets.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_mels: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_audio_ctx: int = 1500
    n_text_ctx: int = 448

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


PRESETS: Dict[str, WhisperConfig] = {
    "tiny": WhisperConfig("tiny", 80, 384, 6, 4, 51865, 384, 6, 4),
    "base": WhisperConfig("base", 80, 512, 8, 6, 51865, 512, 8, 6),
    "small": WhisperConfig("small", 80, 768, 12, 12, 51865, 768, 12, 12),
    "medium": WhisperConfig("medium", 80, 1024, 16, 24, 51865, 1024, 16, 24),
    "large-v2": WhisperConfig("large-v2", 80, 1280, 20, 32, 51865, 1280, 20, 32),
    "large-v3": WhisperConfig("large-v3", 128, 1280, 20, 32, 51866, 1280, 20, 32),
    # reduced-decoder family (openai large-v3-turbo, HF distil-whisper):
    # the parent's encoder with a 4- or 2-layer decoder — at this
    # server's decode-bound serving point the sequential per-token cost
    # drops ~8-16x while encoder FLOPs stay put (reference serves these
    # by name through faster_whisper's model table)
    "large-v3-turbo": WhisperConfig(
        "large-v3-turbo", 128, 1280, 20, 32, 51866, 1280, 20, 4
    ),
    "distil-large-v3": WhisperConfig(
        "distil-large-v3", 128, 1280, 20, 32, 51866, 1280, 20, 2
    ),
    "distil-large-v2": WhisperConfig(
        "distil-large-v2", 80, 1280, 20, 32, 51865, 1280, 20, 2
    ),
    # micro config for hermetic tests: full token layout, tiny dims
    "test": WhisperConfig("test", 80, 64, 2, 2, 51865, 64, 2, 2),
}
PRESETS["large"] = dataclasses.replace(PRESETS["large-v3"], name="large")
PRESETS["turbo"] = dataclasses.replace(
    PRESETS["large-v3-turbo"], name="turbo"
)


def get_config(name: str) -> WhisperConfig:
    key = name.replace("whisper-", "").replace(".en", "")
    if key not in PRESETS:
        raise ValueError(f"unknown whisper size: {name!r}")
    return PRESETS[key]


class TokenLayout(NamedTuple):
    """Special-token ids derived from vocab size (99 langs for 51865-vocab
    v1/v2 checkpoints, 100 for 51866-vocab large-v3)."""

    eot: int
    sot: int
    lang_begin: int
    n_langs: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int

    @property
    def lang_tokens(self) -> range:
        return range(self.lang_begin, self.lang_begin + self.n_langs)


def token_layout(n_vocab: int) -> TokenLayout:
    base = 50257  # GPT-2 BPE vocab size
    n_langs = 100 if n_vocab >= 51866 else 99
    eot = base
    sot = base + 1
    lang_begin = sot + 1
    translate = lang_begin + n_langs
    transcribe = translate + 1
    sot_lm = transcribe + 1
    sot_prev = sot_lm + 1
    no_speech = sot_prev + 1
    no_timestamps = no_speech + 1
    timestamp_begin = no_timestamps + 1
    return TokenLayout(
        eot, sot, lang_begin, n_langs, translate, transcribe,
        sot_lm, sot_prev, no_speech, no_timestamps, timestamp_begin,
    )


# Language code order used by whisper checkpoints (position = token offset).
WHISPER_LANG_CODES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]
