"""The log-mel kernel's FFT plan and tables, held on the CPU.

The CUDA kernel in ``stt_tpu_torch/ops/cuda/mel.cu`` cannot run here, so
this file holds what it is built from:

- the tables the wrapper hands it (the Hann window, the twiddles, the
  sparse filterbank) against the dense constants of ``stt_tpu_torch.ops.mel``
  and the JAX package, bit for bit;
- a Python model of the kernel's own plan: the window load's reflect-index
  arithmetic over tiles of 16 frames, the packing of 400 real samples into
  200 complex ones, the radix-8 stage reading them in digit-reversed order,
  the two radix-5 stages with their twiddle indices, the padded slots, the
  even/odd split step and the power written over the spectrum, then the
  mel sums over each filter's run. In float64 the model's spectrum equals
  ``torch.fft.rfft`` within 1e-12; in float32 its log-mel equals
  ``log_mel_raw`` at the kernel's tolerance (atol 2e-4, rtol 1e-4 after
  normalisation, ``tests/test_pallas_mel.py``).

The kernel itself is held to the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stt_tpu.ops import mel as jmel
from stt_tpu_torch.engine.engine import _encode_wire_rows
from stt_tpu_torch.ops import mel as M
from stt_tpu_torch.ops.kernels import mel as K
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 2e-4, 1e-4
TILE_F, HOP, N_FFT, N = 16, 160, 400, 200
SLOTS = 225


def _slot(p):
    return p + (p >> 3)


# ---- the model of mel.cu, step by step, on (re, im) pairs of arrays --------

def _cmul(a, w):
    return a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0]


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _dft4(b0, b1, b2, b3):
    s0, d0, s1, d1 = _add(b0, b2), _sub(b0, b2), _add(b1, b3), _sub(b1, b3)
    return [_add(s0, s1), (d0[0] + d1[1], d0[1] - d1[0]), _sub(s0, s1),
            (d0[0] - d1[1], d0[1] + d1[0])]


def _dft8(a, r):
    e = _dft4(a[0], a[2], a[4], a[6])
    o = _dft4(a[1], a[3], a[5], a[7])
    o = [o[0],
         (r * (o[1][0] + o[1][1]), r * (o[1][1] - o[1][0])),
         (o[2][1], -o[2][0]),
         (r * (o[3][1] - o[3][0]), -r * (o[3][0] + o[3][1]))]
    return [_add(e[k], o[k]) for k in range(4)] + [_sub(e[k], o[k]) for k in range(4)]


def _dft5(a, c1, s1, c2, s2):
    t1, t2, t3, t4 = _add(a[1], a[4]), _add(a[2], a[3]), _sub(a[1], a[4]), _sub(a[2], a[3])
    b1 = tuple(a[0][i] + c1 * t1[i] + c2 * t2[i] for i in range(2))
    b2 = tuple(a[0][i] + c2 * t1[i] + c1 * t2[i] for i in range(2))
    u1 = tuple(s1 * t3[i] + s2 * t4[i] for i in range(2))
    u2 = tuple(s2 * t3[i] - s1 * t4[i] for i in range(2))
    return [_add(a[0], _add(t1, t2)), (b1[0] + u1[1], b1[1] - u1[0]),
            (b2[0] + u2[1], b2[1] - u2[0]), (b2[0] - u2[1], b2[1] + u2[0]),
            (b1[0] - u1[1], b1[1] + u1[0])]


def kernel_windows(row: np.ndarray) -> np.ndarray:
    """The window load of every tile of one row, by the kernel's index
    arithmetic: (n_tiles * 16, 400) frames, the last tile's frames past
    n_frames included (they read zeros past the reflected tail)."""
    n = row.shape[0]
    n_tiles = -(-(n // HOP) // TILE_F)
    win_len = (TILE_F - 1) * HOP + N_FFT
    frames = []
    for tile in range(n_tiles):
        i = tile * TILE_F * HOP + np.arange(win_len) - N_FFT // 2
        i = np.where(i < 0, -i, i)
        i = np.where(i >= n, 2 * (n - 1) - i, i)
        ok = (i >= 0) & (i < n)
        win = np.where(ok, row[np.clip(i, 0, n - 1)], 0).astype(row.dtype)
        frames += [win[f * HOP: f * HOP + N_FFT] for f in range(TILE_F)]
    return np.stack(frames)


def kernel_spectrum(frames: np.ndarray, dtype):
    """The kernel's FFT of windowed frames (F, 400) -> X as (re, im) of bins
    0..200 and the slice of 450 floats it leaves behind (power over the
    spectrum's padded slots), computed in ``dtype`` with the twiddles
    rounded to ``dtype`` (the kernel: float32)."""
    frames = frames.astype(dtype)
    w = K.hann_window().astype(dtype)
    tw = K.twiddles().astype(dtype)
    c1, s1 = tw[K.TW_RADIX, 0], -tw[K.TW_RADIX, 1]
    c2, s2 = tw[K.TW_RADIX + 1, 0], -tw[K.TW_RADIX + 1, 1]
    buf = np.full((frames.shape[0], 2 * SLOTS), np.nan, dtype)

    def load(p):
        s = _slot(p)
        return buf[:, 2 * s].copy(), buf[:, 2 * s + 1].copy()

    def store(p, v):
        s = _slot(p)
        buf[:, 2 * s], buf[:, 2 * s + 1] = v

    for lane in range(N // 8):  # radix 8, digit-reversed input
        n0 = lane // 5 + 5 * (lane % 5)
        a = [(frames[:, 2 * n] * w[2 * n], frames[:, 2 * n + 1] * w[2 * n + 1])
             for n in (n0 + 25 * m for m in range(8))]
        for k, v in enumerate(_dft8(a, tw[K.TW_RADIX + 2, 0])):
            store(8 * lane + k, v)
    for i in range(N // 5):  # radix 5, lengths 8 -> 40
        c, k1 = divmod(i, 8)
        a = [load(40 * c + k1)] + [_cmul(load(40 * c + 8 * j + k1),
                                         tw[K.TW_STAGE2 + (j - 1) * 8 + k1])
                                   for j in range(1, 5)]
        for k, v in enumerate(_dft5(a, c1, s1, c2, s2)):
            store(40 * c + 8 * k + k1, v)
    for k1 in range(N // 5):  # radix 5, lengths 40 -> 200
        a = [load(k1)] + [_cmul(load(40 * j + k1), tw[K.TW_STAGE3 + (j - 1) * 40 + k1])
                          for j in range(1, 5)]
        for k, v in enumerate(_dft5(a, c1, s1, c2, s2)):
            store(40 * k + k1, v)

    x_re = np.zeros((frames.shape[0], N + 1), dtype)
    x_im = np.zeros_like(x_re)
    power = {}
    for k in range(N // 2 + 1):  # split: bins k and 200 - k
        zk, zc = load(k), load(0 if k == 0 else N - k)
        e = (dtype(0.5) * (zk[0] + zc[0]), dtype(0.5) * (zk[1] - zc[1]))
        o = (dtype(0.5) * (zk[1] + zc[1]), dtype(-0.5) * (zk[0] - zc[0]))
        wo = _cmul(o, tw[K.TW_SPLIT + k])
        a, b = _add(e, wo), _sub(e, wo)
        x_re[:, k], x_im[:, k] = a
        power[k] = a[0] * a[0] + a[1] * a[1]
        if k < N // 2:
            x_re[:, N - k], x_im[:, N - k] = b[0], -b[1]
            power[N - k] = b[0] * b[0] + b[1] * b[1]
    for k, p in power.items():  # all reads are done; the power overwrites the slice
        buf[:, k] = p
    return x_re, x_im, buf


def kernel_log_mel(rows: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """The whole kernel in float32: wire rows (B, T) -> (B, n_mels, F)."""
    audio = M.expand_wire(torch.from_numpy(rows)).numpy()
    n_frames = rows.shape[1] // HOP
    filters, weights = K.sparse_filterbank(n_mels)
    out = []
    for row in audio:
        _, _, slice_ = kernel_spectrum(kernel_windows(row.astype(np.float32)), np.float32)
        mel = np.zeros((n_mels, slice_.shape[0]), np.float32)
        for m, (first, length, offset) in enumerate(filters):
            for i in range(length):
                mel[m] += slice_[:, first + i] * weights[offset + i]
        out.append(np.log10(np.maximum(mel, np.float32(1e-10)))[:, :n_frames])
    return np.stack(out)


def _synth_audio(seconds, seed):
    """chip_smoke.py's test signal: a gliding harmonic tone with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 40.0 * seed + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (sig + 0.02 * rng.normal(0, 1, t.shape)).astype(np.float32)


def _wire_rows(wire, audio):
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    return {"float32": audio, "int16": pcm, "mulaw": _encode_wire_rows(pcm, "mulaw")}[wire]


# ---- the tables ------------------------------------------------------------

@pytest.mark.parametrize("n_mels,longest,nonzeros", [(80, 14, 391), (128, 9, 394)])
def test_sparse_filterbank_rebuilds_the_dense_one(n_mels, longest, nonzeros):
    filters, weights = K.sparse_filterbank(n_mels)
    assert filters.dtype == np.int32 and weights.dtype == np.float32
    dense = np.zeros((n_mels, N + 1), np.float32)
    for m, (first, length, offset) in enumerate(filters):
        dense[m, first:first + length] = weights[offset:offset + length]
    assert np.array_equal(dense, M.mel_filterbank(n_mels))
    assert np.array_equal(dense, jmel.mel_filterbank(n_mels))
    assert weights.size == nonzeros and (weights > 0).all()
    assert filters[:, 1].min() >= 1 and filters[:, 1].max() == longest
    assert np.array_equal(filters[:, 2], np.concatenate([[0], np.cumsum(filters[:-1, 1])]))
    assert (np.count_nonzero(dense, axis=0) <= 2).all()  # no bin in three filters


def test_window_table_is_the_window_inside_dft_basis():
    # column 0 of the basis is window * cos(0), rounded once to float32
    window = K.hann_window()
    assert window.dtype == np.float32 and window.shape == (N_FFT,)
    assert np.array_equal(window, M._dft_basis()[:, 0])
    assert np.array_equal(window, jmel._dft_basis()[:, 0])
    assert np.array_equal(window, torch.hann_window(N_FFT, dtype=torch.float64)
                          .numpy().astype(np.float32))


def _twiddle_angles():
    """(index, turns) of every twiddle, by the layout mel.cu reads."""
    for j in range(1, 5):
        for k1 in range(8):
            yield K.TW_STAGE2 + (j - 1) * 8 + k1, j * k1 / 40
        for k1 in range(40):
            yield K.TW_STAGE3 + (j - 1) * 40 + k1, j * k1 / 200
    for k in range(101):
        yield K.TW_SPLIT + k, k / 400
    for i, turns in enumerate((1 / 5, 2 / 5, 1 / 8)):
        yield K.TW_RADIX + i, turns


def test_twiddle_table_is_float64_rounded_once():
    table = K._device_constants(torch.device("cpu"), 80)[1].numpy()
    assert table.dtype == np.float32 and table.shape == (K.TW_COUNT, 2)
    seen = set()
    for index, turns in _twiddle_angles():
        seen.add(index)
        exact = (math.cos(2 * math.pi * turns), -math.sin(2 * math.pi * turns))
        assert tuple(table[index]) == tuple(np.float32(x) for x in exact), index
        ulp = np.spacing(np.abs(table[index]))
        assert (np.abs(table[index].astype(np.float64) - exact) <= ulp / 2).all()
    assert seen == set(range(K.TW_COUNT))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_device_constants_hand_the_tables_over(n_mels):
    window, twiddle, filters, weights = K._device_constants(torch.device("cpu"), n_mels)
    assert window.dtype == twiddle.dtype == weights.dtype == torch.float32
    assert filters.dtype == torch.int32 and filters.shape == (n_mels, 3)
    assert all(t.is_contiguous() for t in (window, twiddle, filters, weights))
    assert torch.equal(window, torch.from_numpy(K.hann_window()))
    assert torch.equal(twiddle, torch.from_numpy(K.twiddles().astype(np.float32)))
    assert int(filters[-1, 1] + filters[-1, 2]) == weights.numel()


# ---- the plan ---------------------------------------------------------------

def test_fft_plan_touches_every_value_once_per_stage():
    reads = sorted(lane // 5 + 5 * (lane % 5) + 25 * m for lane in range(25) for m in range(8))
    assert reads == list(range(N))  # the radix-8 stage reads each z[n] once
    stage2 = sorted(40 * c + 8 * j + k1 for c in range(5) for k1 in range(8) for j in range(5))
    stage3 = sorted(40 * j + k1 for k1 in range(40) for j in range(5))
    assert stage2 == stage3 == list(range(N))
    slots = [_slot(p) for p in range(N)]
    assert len(set(slots)) == N and max(slots) < SLOTS
    assert 2 * SLOTS >= N + 1  # the power rows fit in the warp's slice


@pytest.mark.parametrize("seconds", [0.02, 1.0, 1.5, 2.0])
def test_window_load_is_reflect_padding(seconds):
    """The kernel's index arithmetic gives F.pad's reflect frames, and the
    last tile's frames past n_frames stay in bounds (they are not stored)."""
    rng = np.random.default_rng(4)
    row = rng.normal(0, 1, int(16000 * seconds)).astype(np.float32)
    n_frames = row.size // HOP
    got = kernel_windows(row)
    assert got.shape[0] % TILE_F == 0 and got.shape[0] >= n_frames
    padded = F.pad(torch.from_numpy(row)[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    ref = padded.unfold(-1, N_FFT, HOP)[:n_frames].numpy()
    assert np.array_equal(got[:n_frames], ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fft_plan_in_float64_is_the_real_dft(seed):
    frames = np.random.default_rng(seed).normal(0, 1, (37, N_FFT))
    x_re, x_im, buf = kernel_spectrum(frames, np.float64)
    y = torch.from_numpy(frames * K.hann_window().astype(np.float64))
    ref = torch.fft.rfft(y, dim=-1).numpy()
    np.testing.assert_allclose(x_re, ref.real, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x_im, ref.imag, rtol=0, atol=1e-12)
    np.testing.assert_allclose(buf[:, :N + 1], np.abs(ref) ** 2, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
def test_fft_plan_in_float32_matches_log_mel_raw(wire, n_mels):
    audio = np.stack([_synth_audio(1.5, seed=s) for s in (0, 3)])
    rows = _wire_rows(wire, audio)
    got = M.normalize_log_mel(torch.from_numpy(kernel_log_mel(rows, n_mels)))
    ref = M.normalize_log_mel(K.log_mel_spectrogram_plain(torch.from_numpy(rows), n_mels))
    assert got.shape == ref.shape == (2, n_mels, 150)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows", [
    np.zeros((1, 3200), np.int16),                                  # silence
    np.full((1, 3200), 128, np.uint8),                              # mu-law near-zero DC
    np.full((1, 3200), -32768, np.int16),                           # int16 extremes
    np.random.default_rng(5).choice(np.array([-32768, 32767], np.int16), (1, 3200)),
    np.random.default_rng(6).choice(np.array([0, 255], np.uint8), (1, 3200)),
], ids=["silence", "mulaw-dc", "int16-min", "int16-extremes", "mulaw-extremes"])
def test_fft_plan_in_float32_at_the_edges(rows):
    got = M.normalize_log_mel(torch.from_numpy(kernel_log_mel(rows)))
    ref = M.normalize_log_mel(K.log_mel_spectrogram_plain(torch.from_numpy(rows)))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
