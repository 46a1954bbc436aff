"""The card's peaks, and the operation and byte counts of the log-mel
front end that every Whisper-encoder model shares.

The yardstick for the model step's share of peak (``mfu_pct.*``, whose
FLOPs a request takes from its architecture's ``request_flops`` in
``benchmark/architectures/``) and the log-mel kernel's share of its
roofline. Counts come from shapes and from what the request itself fixes
(its bucket, its prompt, the tokens it produced), never from what the
program reports about its own speed.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12      # outside the tensor cores
H100_HBM_BYTES = 3.35e12

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16000
FRAMES_PER_SEC = SAMPLE_RATE // HOP   # 100


def mel_nonzeros(n_mels: int) -> int:
    """Non-zero weights of the Slaney filterbank."""
    import numpy as np

    from ..reference.whisper import mel_filters

    return int(np.count_nonzero(mel_filters(n_mels)))


def mel_least_seconds(rows: int, bucket_sec: float, n_mels: int, wire_bytes: int,
                      nonzeros: int) -> float:
    """Least time of one log-mel launch over ``rows`` rows of one bucket:
    the larger of its operations (a 400-point real FFT a frame at 2.5 N
    log2 N, the window, the power, the filterbank's non-zeros and the log)
    over the float32 peak, and its bytes (each input sample read once at
    ``wire_bytes``, each float32 output written once) over HBM bandwidth.
    The filterbank's few KB of constants are not counted."""
    frames = rows * int(round(bucket_sec * FRAMES_PER_SEC))
    n_bins = N_FFT // 2 + 1
    per_frame = 2.5 * N_FFT * math.log2(N_FFT) + N_FFT + 3 * n_bins + 2 * nonzeros + n_mels
    samples = rows * int(bucket_sec * SAMPLE_RATE)
    nbytes = samples * wire_bytes + frames * n_mels * 4
    return max(frames * per_frame / H100_F32_FLOPS, nbytes / H100_HBM_BYTES)
