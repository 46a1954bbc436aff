"""Word-level timestamps via cross-attention DTW: the port's own copy of
``stt_tpu/models/timing.py`` (openai timing.py semantics), numpy on the
host, so that the port imports nothing of the JAX package.

Pipeline (the device half is
:func:`stt_tpu_torch.models.whisper.cross_attention_weights`):

1. select the generated TEXT token positions of the sequence,
2. z-normalize each head's attention over the token axis, median-filter
   along the audio axis, average heads -> one (T_text, T_audio) matrix,
3. monotonic DTW over ``-matrix`` -> a token->frame alignment path
   (each audio frame = 0.02 s at the encoder's 50 Hz output),
4. token jump-times -> word boundaries by regrouping byte-level BPE
   pieces on leading spaces (per-token fallback for unsegmented scripts).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

AUDIO_TIME_PER_FRAME = 0.02  # encoder output: 50 frames/sec


class WordTiming(NamedTuple):
    word: str
    start: float
    end: float


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with edge padding (openai's
    medfilt; width must be odd)."""
    if width <= 1 or x.shape[-1] <= width:
        return x
    half = width // 2
    padded = np.concatenate(
        [x[..., :1].repeat(half, -1), x, x[..., -1:].repeat(half, -1)],
        axis=-1,
    )
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, -1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray):
    """Monotonic DTW over a (N, M) cost matrix; steps (1,0), (0,1), (1,1).
    Returns (text_indices, time_indices) of the optimal path.

    The DP is vectorized over anti-diagonals (cells with i+j == d depend
    only on diagonals d-1 and d-2), so the inner work is numpy over up to
    min(N, M) cells instead of N*M Python iterations — a ~224x1500
    alignment drops from hundreds of ms to a few ms of host time, which
    matters because this runs serialized inside the engine loop."""
    n, m = cost.shape
    trace = np.zeros((n + 1, m + 1), np.int8)
    # diagonal d holds acc[i, d - i], indexed by i; rows/cols 0 are +inf
    # boundaries except acc[0, 0] = 0
    prev2 = np.full(n + 1, np.inf, np.float64)  # diagonal d-2
    prev1 = np.full(n + 1, np.inf, np.float64)  # diagonal d-1
    prev2[0] = 0.0                              # acc[0, 0]
    cost64 = cost.astype(np.float64, copy=False)
    for d in range(2, n + m + 1):
        i_lo, i_hi = max(1, d - m), min(n, d - 1)
        cur = np.full(n + 1, np.inf, np.float64)
        if i_lo <= i_hi:
            i = np.arange(i_lo, i_hi + 1)
            j = d - i
            c0 = prev2[i - 1]   # acc[i-1, j-1]
            c1 = prev1[i - 1]   # acc[i-1, j]
            c2 = prev1[i]       # acc[i, j-1]
            # tie-break identical to the scalar version: prefer the
            # diagonal step, then (1,0), then (0,1)
            d01 = c0 <= c1
            best01 = np.where(d01, c0, c1)
            t01 = np.where(d01, 0, 1)
            use01 = best01 <= c2
            best = np.where(use01, best01, c2)
            t = np.where(use01, t01, 2).astype(np.int8)
            cur[i] = best + cost64[i - 1, j - 1]
            trace[i, j] = t
        prev2, prev1 = prev1, cur
    i, j = n, m
    text_idx: List[int] = []
    time_idx: List[int] = []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


def _token_jump_times(
    matrix: np.ndarray, n_frames: int
) -> np.ndarray:
    """(T_text, T_audio) attention matrix -> per-token start times.

    Returns (T_text + 1,) seconds: entry t is when token t begins; the
    final entry is the end of the last token."""
    text_idx, time_idx = dtw_path(-matrix[:, :n_frames].astype(np.float64))
    n_tokens = matrix.shape[0]
    jumps = np.zeros(n_tokens + 1, np.float64)
    prev_t = -1
    for ti, fi in zip(text_idx, time_idx):
        if ti != prev_t:
            jumps[ti] = fi * AUDIO_TIME_PER_FRAME
            prev_t = ti
    jumps[n_tokens] = (
        (time_idx[-1] + 1) * AUDIO_TIME_PER_FRAME if len(time_idx)
        else n_frames * AUDIO_TIME_PER_FRAME
    )
    # enforce monotonicity (DTW can revisit a token row only forward, but
    # unvisited rows keep 0 — carry forward)
    for t in range(1, n_tokens + 1):
        if jumps[t] < jumps[t - 1]:
            jumps[t] = jumps[t - 1]
    return jumps


def group_word_tokens(
    token_ids: Sequence[int], tokenizer
) -> List[List[int]]:
    """Group byte-level BPE token indices into words: a token whose text
    starts with a space (or an opening punctuation boundary) begins a new
    word. Scripts without spaces fall back to one word per token (openai
    split_tokens_on_unicode behavior for CJK)."""
    groups: List[List[int]] = []
    any_space = False
    for idx, tok in enumerate(token_ids):
        piece = tokenizer.decode([int(tok)])
        starts_word = piece.startswith(" ") or not groups
        if piece.startswith(" "):
            any_space = True
        if starts_word:
            groups.append([idx])
        else:
            groups[-1].append(idx)
    if not any_space and groups:
        # unsegmented script: token-per-word
        return [[i] for g in groups for i in g]
    return groups


def word_alignments(
    weights: np.ndarray,
    token_ids: Sequence[int],
    token_positions: Sequence[int],
    tokenizer,
    duration: float,
    median_width: int = 7,
) -> List[WordTiming]:
    """Align generated text tokens to audio and group into timed words.

    weights: (A, T_seq, T_audio) selected attention heads (flattened
    layersxheads) for ONE sequence. token_ids/token_positions: the text
    tokens and their positions within T_seq. duration: real audio seconds
    (frames beyond it are padding).
    """
    if not len(token_ids):
        return []
    n_frames = max(1, min(
        int(round(duration / AUDIO_TIME_PER_FRAME)), weights.shape[-1]
    ))
    w = weights[:, list(token_positions), :].astype(np.float64)
    mean = w.mean(axis=1, keepdims=True)
    std = w.std(axis=1, keepdims=True) + 1e-9
    w = (w - mean) / std
    w = median_filter(w, median_width)
    matrix = w.mean(axis=0)                       # (T_text, T_audio)
    jumps = _token_jump_times(matrix, n_frames)

    words: List[WordTiming] = []
    for group in group_word_tokens(token_ids, tokenizer):
        text = tokenizer.decode([int(token_ids[i]) for i in group]).strip()
        if not text:
            continue
        start = float(jumps[group[0]])
        end = float(jumps[group[-1] + 1])
        words.append(WordTiming(
            text,
            max(0.0, min(start, duration)),
            max(0.0, min(max(end, start), duration)),
        ))
    return words


__all__ = [
    "AUDIO_TIME_PER_FRAME",
    "WordTiming",
    "dtw_path",
    "group_word_tokens",
    "median_filter",
    "word_alignments",
]
