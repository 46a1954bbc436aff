"""Whisper text tokenizer: every local vocab format, with a hermetic fallback.

Own copy of ``stt_tpu/models/tokenizer.py``, reading the token layout
from the port's presets. Real checkpoints pair with a byte-level BPE
vocabulary in one of three local formats: HF ``tokenizer.json`` (loaded
through ``tokenizers``), ``vocab.json`` + ``merges.txt`` (pure-python
BPE) or ``*.tiktoken`` rank tables (loaded through ``tiktoken``). Both
optional packages are imported only when their format is found. Without
any vocab, :class:`FallbackTokenizer` maps ids to stable pseudo-words,
so equal token ids always produce equal text.
"""

from __future__ import annotations

import base64
import glob
import json
import logging
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

from .presets import TokenLayout, token_layout

LOGGER = logging.getLogger("stt_tpu_torch")

# openai-whisper's regex split pattern (whisper/tokenizer.py get_encoding)
_WHISPER_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def _byte_unicode_map() -> Dict[int, str]:
    """GPT-2's reversible bytes<->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """Byte-level BPE over a local vocab.json + merges.txt pair."""

    def __init__(self, vocab: Dict[str, int], merges: List[tuple], n_vocab: int):
        self.layout: TokenLayout = token_layout(n_vocab)
        self._encoder = vocab
        self._decoder = {v: k for k, v in vocab.items()}
        self._bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        b2u = _byte_unicode_map()
        self._b2u = b2u
        self._u2b = {u: b for b, u in b2u.items()}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str, n_vocab: int) -> "BPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[tuple] = []
        merges_path = os.path.join(path, "merges.txt")
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, n_vocab)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self._bpe_ranks.get(p, float("inf")))
            if best not in self._bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        mapped = "".join(self._b2u[b] for b in text.encode("utf-8"))
        out: List[int] = []
        for piece in self._bpe(mapped):
            if piece in self._encoder:
                out.append(self._encoder[piece])
            else:
                out.extend(self._encoder[c] for c in piece if c in self._encoder)
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        pieces = [
            self._decoder[t]
            for t in tokens
            if t < self.layout.eot and t in self._decoder
        ]
        text = "".join(pieces)
        data = bytes(self._u2b[c] for c in text if c in self._u2b)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """HF fast-format ``tokenizer.json`` via the local ``tokenizers``
    runtime — the file every HF whisper checkpoint directory ships."""

    def __init__(self, path: str, n_vocab: int):
        from tokenizers import Tokenizer

        self.layout: TokenLayout = token_layout(n_vocab)
        self._tok = Tokenizer.from_file(path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, tokens: Sequence[int]) -> str:
        ids = [int(t) for t in tokens if int(t) < self.layout.eot]
        return self._tok.decode(ids)


class TiktokenTokenizer:
    """openai-whisper assets format: a ``base64(token_bytes) rank`` line
    per mergeable token (``multilingual.tiktoken``/``gpt2.tiktoken``),
    loaded into a local ``tiktoken.Encoding`` with whisper's split
    pattern. Specials occupy ids [len(ranks), n_vocab) exactly as
    openai-whisper appends them; we only ever encode/decode text ids, so
    their names are immaterial."""

    def __init__(self, path: str, n_vocab: int):
        import tiktoken

        self.layout: TokenLayout = token_layout(n_vocab)
        ranks: Dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                token_b64, rank = line.split()
                ranks[base64.b64decode(token_b64)] = int(rank)
        n_base = len(ranks)
        specials = {
            f"<|special_{i}|>": n_base + i
            for i in range(max(0, n_vocab - n_base))
        }
        self._enc = tiktoken.Encoding(
            name=os.path.basename(path),
            explicit_n_vocab=max(n_vocab, n_base),
            pat_str=_WHISPER_PAT,
            mergeable_ranks=ranks,
            special_tokens=specials,
        )

    def encode(self, text: str) -> List[int]:
        return self._enc.encode(text, disallowed_special=())

    def decode(self, tokens: Sequence[int]) -> str:
        ids = [int(t) for t in tokens if int(t) < self.layout.eot]
        return self._enc.decode(ids, errors="replace")


_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


class FallbackTokenizer:
    """Deterministic id<->pseudo-text mapping for weight-free operation.

    Non-special ids render as stable space-prefixed syllable words (so the
    committed/unstable transcript machinery sees realistic word boundaries);
    encode() maps bytes onto low ids, making encode(decode(x)) stable for
    the byte range.
    """

    def __init__(self, n_vocab: int):
        self.layout: TokenLayout = token_layout(n_vocab)

    def _word(self, token: int) -> str:
        syllables = []
        value = token
        for _ in range(2 + token % 2):
            c = _CONSONANTS[value % len(_CONSONANTS)]
            value //= len(_CONSONANTS)
            v = _VOWELS[value % len(_VOWELS)]
            value //= len(_VOWELS)
            syllables.append(c + v)
        return " " + "".join(syllables)

    def encode(self, text: str) -> List[int]:
        return [b for b in text.encode("utf-8")]

    def decode(self, tokens: Sequence[int]) -> str:
        parts: List[str] = []
        for t in tokens:
            t = int(t)
            if t >= self.layout.eot:
                continue  # specials/timestamps render as nothing
            if t < 256:
                try:
                    parts.append(bytes([t]).decode("latin-1"))
                except ValueError:  # pragma: no cover
                    continue
            else:
                parts.append(self._word(t))
        return "".join(parts)


def load_tokenizer(path: Optional[str], n_vocab: int):
    """Real tokenizer from a local file/dir when present, else the fallback.

    ``path`` may be a directory (an HF checkpoint or tokenizer dir — the
    usual case, searched in preference order: tokenizer.json,
    vocab.json+merges.txt, ``*.tiktoken``) or a direct path to a
    ``tokenizer.json`` / ``*.tiktoken`` file.
    """
    try:
        if path and os.path.isfile(path):
            if path.endswith(".tiktoken"):
                return TiktokenTokenizer(path, n_vocab)
            if path.endswith(".json"):
                return HFTokenizer(path, n_vocab)
        elif path and os.path.isdir(path):
            fast = os.path.join(path, "tokenizer.json")
            if os.path.exists(fast):
                return HFTokenizer(fast, n_vocab)
            if os.path.exists(os.path.join(path, "vocab.json")) and (
                os.path.exists(os.path.join(path, "merges.txt"))
            ):
                return BPETokenizer.from_dir(path, n_vocab)
            tk = sorted(glob.glob(os.path.join(path, "*.tiktoken")))
            if tk:
                return TiktokenTokenizer(tk[0], n_vocab)
    except Exception:
        LOGGER.exception("tokenizer load failed for %r; using fallback", path)
    if path:
        LOGGER.warning(
            "no tokenizer vocab found under %r; using the byte-fallback "
            "tokenizer (transcripts from real weights will be approximate)",
            path,
        )
    return FallbackTokenizer(n_vocab)


__all__ = [
    "BPETokenizer",
    "FallbackTokenizer",
    "HFTokenizer",
    "TiktokenTokenizer",
    "load_tokenizer",
]
