"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on hosts without a CUDA
device. This file imports no JAX, so it also runs on the GPU host:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

The log-mel kernel is held at the tolerance of ``tests/test_pallas_mel.py``
(atol 2e-4, rtol 1e-4) after the shared epilogue: kernel and plain
version are both float32; the kernel takes the DFT as an FFT and sums
only the filterbank's non-zeros, the plain version takes both as dense
products, so they differ only in rounding. The
cross-attention decode kernel is held at atol 1e-3, rtol 1e-2 and the flash
kernel at atol 2e-3, rtol 1e-2, at the shapes the serving path gives them
and a few more. Those limits are set from the size of the values: the
flash inputs have q and k at whisper's d_head**-0.25 scale, whose outputs
are ~0.03-0.05 at 500 to 1500 keys; the decode inputs have unit-variance q
and K, a sharper softmax with outputs of ~1. Both sides round the weights to bf16, so the decode kernel
differs only where a weight's float32 value lands on the other side of a
bf16 rounding step; the flash kernel rounds the unnormalised weights where
the plain version rounds normalised ones, and its bf16 output may differ
by one bf16 step (< 0.8% of |x|). The flash kernel's float32 body is held
at atol FLASH_F32_ATOL, rtol FLASH_F32_RTOL: nothing on either side is
rounded below float32, so the two differ only in the order of float32
sums over up to 1500 keys (~1e-7 relative), far inside the bf16 limit,
which would pass a kernel that dropped the ragged key tail.
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.engine.engine import _encode_wire_rows
from stt_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain
from stt_tpu_torch.ops.kernels.mel import log_mel_spectrogram_plain, mel_logspec
from stt_tpu_torch.ops.kernels.xattn_decode import (
    MAX_TA, plan_split, xattn_decode, xattn_decode_plain,
)
from stt_tpu_torch.ops.mel import normalize_log_mel

ATOL, RTOL = 2e-4, 1e-4
XATTN_ATOL, XATTN_RTOL = 1e-3, 1e-2
FLASH_ATOL, FLASH_RTOL = 2e-3, 1e-2
FLASH_F32_ATOL, FLASH_F32_RTOL = 1e-5, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(wire, batch, seconds, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(16000 * seconds))) / 16000.0
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t) + 0.05 * rng.normal(0, 1, t.shape)
        for i in range(batch)
    ]).astype(np.float32)
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    return torch.from_numpy({"mulaw": _encode_wire_rows(pcm, "mulaw"), "int16": pcm,
                             "float32": audio}[wire])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["mulaw", "int16", "float32"])
@pytest.mark.parametrize("batch,seconds", [(1, 1.0), (3, 5.0), (2, 1.5), (4, 30.0)])
def test_mel_kernel_matches_plain(cuda_device, wire, batch, seconds):
    rows = _rows(wire, batch, seconds).to(cuda_device)
    before = mel_logspec.launches
    got = normalize_log_mel(mel_logspec(rows))
    torch.cuda.synchronize()
    assert mel_logspec.launches == before + 1
    assert got.shape == (batch, 80, int(seconds * 100))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["mulaw", "int16"])
@pytest.mark.parametrize("seconds", [1.0, 2.0, 5.0, 10.0])
def test_mel_kernel_served_groups(cuda_device, wire, seconds):
    """The groups phase 3a of chip_smoke.py serves: 2 requests padded to
    the batch bucket of 4 rows, at each of the 1/2/5/10 s buckets."""
    rows = _rows(wire, 4, seconds, seed=2).to(cuda_device)
    got = normalize_log_mel(mel_logspec(rows))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["mulaw", "int16", "float32"])
@pytest.mark.parametrize("batch,seconds", [(16, 10.0), (1, 1.5), (2, 30.0)])
def test_mel_kernel_128_mels(cuda_device, wire, batch, seconds):
    rows = _rows(wire, batch, seconds, seed=3).to(cuda_device)
    got = normalize_log_mel(mel_logspec(rows, 128))
    assert got.shape == (batch, 128, int(seconds * 100))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows, 128))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [2, 15, 17, 107, 1501])
def test_mel_kernel_ragged_last_tile(cuda_device, n_frames):
    """Frame counts that are not a multiple of the 16-frame tile: frames
    past the end are computed and never stored, so they leave no trace."""
    rows = _rows("int16", 3, n_frames / 100, seed=4).to(cuda_device)
    got = mel_logspec(rows)
    assert got.shape == (3, 80, n_frames)
    # a frame stored past the end would land on the next mel row's first frames
    torch.testing.assert_close(normalize_log_mel(got),
                               normalize_log_mel(log_mel_spectrogram_plain(rows)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wire,values", [("int16", (-32768, 32767)), ("mulaw", (0, 255))])
def test_mel_kernel_wire_extremes(cuda_device, wire, values):
    """Full-scale rows: random picks of the two extreme codes, and each
    extreme held constant (all power in the lowest bins)."""
    dtype = torch.int16 if wire == "int16" else torch.uint8
    rng = np.random.default_rng(5)
    noise = rng.choice(np.array(values), (2, 16000))
    const = np.repeat(np.array(values)[:, None], 16000, axis=1)
    rows = torch.from_numpy(np.concatenate([noise, const]).astype(
        np.int16 if wire == "int16" else np.uint8)).to(cuda_device)
    assert rows.dtype == dtype
    got = normalize_log_mel(mel_logspec(rows))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_mel_kernel_silence(cuda_device):
    rows = torch.zeros((2, 16000), dtype=torch.int16, device=cuda_device)
    got = normalize_log_mel(mel_logspec(rows))
    ref = normalize_log_mel(log_mel_spectrogram_plain(rows))
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_mel_kernel_rejects_bad_input(cuda_device):
    with pytest.raises(ValueError):
        mel_logspec(torch.zeros((1, 16007), device=cuda_device))
    with pytest.raises(TypeError):
        mel_logspec(torch.zeros((1, 16000), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        mel_logspec(torch.zeros((16000, 2), device=cuda_device).t())
    with pytest.raises(ValueError, match="at most 128 mels"):
        mel_logspec(torch.zeros((1, 16000), device=cuda_device), n_mels=129)


def _xattn_inputs(storage, b, ta, h=12, dh=64, seed=0):
    """q bf16 (B, H, Dh) and k/v in ``storage``, as precompute_cross_kv
    stores them; for int8 also the per-(row, head) scales."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, dh)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32))
    if storage == "float32":
        return q, k, v, None
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    if storage == "fp8":
        return q, k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn), None
    if storage == "int8":
        def q8(x):
            s = torch.clamp_min(x.float().abs().amax(dim=(2, 3), keepdim=True) / 127.0, 1e-12)
            return torch.round(x.float() / s).to(torch.int8), s
        (kq, ks), (vq, vs) = q8(k), q8(v)
        return (q * ks[..., 0].to(torch.bfloat16)).contiguous(), kq, vq, vs[..., 0]
    return q, k, v, None


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("b,ta", [(1, 50), (4, 500), (4, 1500), (16, 1500), (64, 500)])
def test_xattn_kernel_matches_plain(cuda_device, storage, b, ta):
    q, k, v, v_scale = _xattn_inputs(storage, b, ta)
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    before = xattn_decode.launches
    got = xattn_decode(q, k, v)
    torch.cuda.synchronize()
    assert xattn_decode.launches == before + 1
    assert got.shape == (b, 12, 64) and got.dtype == torch.float32
    ref = xattn_decode_plain(q, k, v)
    if v_scale is not None:
        got, ref = got * v_scale.to(cuda_device), ref * v_scale.to(cuda_device)
    torch.testing.assert_close(got, ref, atol=XATTN_ATOL, rtol=XATTN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("storage,h,dh,ta", [("float32", 12, 64, 500), ("bf16", 20, 64, 250),
                                             ("fp8", 2, 32, 1500), ("bf16", 4, 16, 40)])
def test_xattn_kernel_other_shapes(cuda_device, storage, h, dh, ta):
    q, k, v, _ = _xattn_inputs(storage, 3, ta, h=h, dh=dh, seed=1)
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    got = xattn_decode(q, k, v)
    torch.testing.assert_close(got, xattn_decode_plain(q, k, v), atol=XATTN_ATOL,
                               rtol=XATTN_RTOL)
    got32 = xattn_decode(q.float(), k, v)  # a float32 q is rounded to bf16 on load
    torch.testing.assert_close(got32, got, atol=0, rtol=0)


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("storage,b,h,ta,clusters", [
    ("fp8", 64, 12, 500, 1),      # many (row, head) pairs: no split
    ("bf16", 1, 12, 1, 1),        # a single key
    ("fp8", 16, 12, 1500, 2),
    ("int8", 8, 12, 1500, 4),
    ("fp8", 4, 12, 1500, 8),      # the served shape
    ("bf16", 4, 12, 1001, 8),     # Ta not a multiple of the chunk
    ("float32", 2, 12, 333, 8),
    ("fp8", 1, 12, 20000, 8),     # above the one-block cap of 8,128 fp8 keys
    ("bf16", 1, 2, 70000, 16),    # above 8 x CHUNK_MAX: a non-portable cluster
])
def test_xattn_kernel_cluster_sizes(cuda_device, storage, b, h, ta, clusters):
    """Every cluster size the planner picks, the ragged last chunk and Ta
    above the old one-block cap, against the plain version."""
    q, k, v, v_scale = _xattn_inputs(storage, b, ta, h=h, seed=3)
    assert plan_split(b * h, ta, 64, k.element_size(), _sms())[0] == clusters
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    got = xattn_decode(q, k, v)
    ref = xattn_decode_plain(q, k, v)
    if v_scale is not None:
        got, ref = got * v_scale.to(cuda_device), ref * v_scale.to(cuda_device)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=XATTN_ATOL, rtol=XATTN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ta", [(4, 1500), (1, 70000)])
def test_xattn_kernel_is_deterministic(cuda_device, b, ta):
    """Partials meet in rank order, with no atomics: two calls agree bit for bit."""
    q, k, v, _ = _xattn_inputs("fp8", b, ta, h=12 if b > 1 else 2, seed=4)
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    first = xattn_decode(q, k, v)
    for _ in range(3):
        assert torch.equal(xattn_decode(q, k, v), first)


@pytest.mark.cuda
def test_xattn_kernel_rejects_bad_input(cuda_device):
    q, k, v, _ = _xattn_inputs("bf16", 2, 50)
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    with pytest.raises(TypeError):
        xattn_decode(q.half(), k, v)
    with pytest.raises(TypeError):
        xattn_decode(q, k.half(), v.half())
    with pytest.raises(TypeError):
        xattn_decode(q, k, v.float())
    with pytest.raises(ValueError):
        xattn_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="head dim"):
        xattn_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     v[..., :48].contiguous())
    long_ta = MAX_TA + 1
    big = torch.zeros((1, 12, long_ta, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        xattn_decode(q[:1], big, big)
    with pytest.raises(ValueError):
        xattn_decode(q.cpu(), k, v)


def _flash_inputs(b, t, h=12, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    scale = dh ** -0.25
    qkv = [torch.from_numpy(rng.normal(0, 1, (b, h, t, dh)).astype(np.float32))
           for _ in range(3)]
    bf = torch.bfloat16
    return (qkv[0] * scale).to(bf), (qkv[1] * scale).to(bf), qkv[2].to(bf)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(1, 512), (1, 1500), (4, 1500), (16, 1500), (2, 600)])
def test_flash_kernel_matches_plain(cuda_device, b, t):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs(b, t))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=FLASH_ATOL, rtol=FLASH_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,t", [(32, 1500), (16, 77), (64, 700)])
def test_flash_kernel_other_shapes(cuda_device, dh, t):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs(2, t, h=3, dh=dh))
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=FLASH_ATOL, rtol=FLASH_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,dh", [
    (3, 4, 333, 64),     # T a multiple of neither the 128-query nor the 128-key tile
    (1, 2, 129, 64),     # one real row in the last tile
    (2, 3, 1, 32),       # a single position
    (64, 8, 200, 64),    # B*H 512: 1,024 blocks, more than the SMs hold at once
    (1, 1, 3000, 16),
])
def test_flash_kernel_ragged_and_wide(cuda_device, b, h, t, dh):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs(b, t, h=h, dh=dh, seed=2))
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=FLASH_ATOL, rtol=FLASH_RTOL)


def _flash_inputs_f32(b, t, h, dh, seed=6):
    rng = np.random.default_rng(seed)
    scale = dh ** -0.25
    return tuple(torch.from_numpy((rng.normal(0, 1, (b, h, t, dh)) * sc).astype(np.float32))
                 for sc in (scale, scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,dh", [
    (1, 12, 512, 64), (4, 12, 1500, 64), (3, 4, 333, 64),
    (2, 2, 1500, 32), (2, 3, 512, 16), (1, 2, 333, 16), (2, 3, 1, 32),
    (1, 12, 1500, 64), (16, 12, 1500, 64),   # the served 1- and 16-row buckets
    (2, 3, 64, 64), (2, 3, 65, 64),          # one whole tile; one key in the last
    (1, 4, 129, 32), (1, 12, 1499, 64),      # around the 128-row / 64-key tiles
    (32, 16, 200, 64),                       # B*H 512
])
def test_flash_kernel_float32_matches_plain(cuda_device, b, h, t, dh):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs_f32(b, t, h, dh))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), atol=FLASH_F32_ATOL,
                               rtol=FLASH_F32_RTOL)


@pytest.mark.cuda
def test_flash_kernel_is_deterministic(cuda_device):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs(4, 1500, seed=5))
    first = flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v), first)


@pytest.mark.cuda
@pytest.mark.parametrize("t,dh", [(1500, 64), (600, 32), (129, 16)])
def test_flash_kernel_float32_every_split(cuda_device, t, dh):
    """Every key split the launcher accepts (the planner picks one of them)
    gives the plain version's output; a split that would leave a block
    without a key tile is refused before launch."""
    from stt_tpu_torch.ops.kernels.flash_attention import F32_KEYS, F32_MAX_SPLIT, _launcher

    b, h = 1, 3
    q, k, v = (x.to(cuda_device) for x in _flash_inputs_f32(b, t, h, dh, seed=8))
    ref = flash_attention_plain(q, k, v)
    launch = _launcher(torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    n_tiles = -(-t // F32_KEYS)
    for splits in range(1, F32_MAX_SPLIT + 2):
        out = torch.full_like(q, float("nan"))
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, dh,
                    splits, stream)
        per = -(-n_tiles // splits)
        if splits > F32_MAX_SPLIT or -(-n_tiles // per) != splits:
            assert rc != 0, f"{splits} splits of {n_tiles} tiles launched"
            continue
        assert rc == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=FLASH_F32_ATOL, rtol=FLASH_F32_RTOL,
                                   msg=lambda m: f"{splits} splits: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_flash_kernel_float32_is_deterministic(cuda_device, b):
    """Fixed-order sums, the split's combine in rank order, no atomics: two
    calls agree bit for bit (1 row takes the split, 4 rows too)."""
    q, k, v = (x.to(cuda_device) for x in _flash_inputs_f32(b, 1500, 12, 64, seed=9))
    first = flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v), first)


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_input(cuda_device):
    q, k, v = (x.to(cuda_device) for x in _flash_inputs(1, 600, h=2))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k, v.float())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(x.float()[..., :48].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :500], v[:, :, :500])


@pytest.mark.cuda
def test_float32_engine_with_flash_serves_30s_on_the_card(cuda_device):
    """whisper-small in float32 with flash on serves a 30 s request through
    the float32 body (12 launches, one per encoder layer, for its one
    encode) and decodes the tokens of the same engine with flash off."""
    from stt_tpu_torch.engine.engine import DecodeRequest, WhisperEngine

    rng = np.random.default_rng(7)
    t = np.arange(16000 * 30) / 16000.0
    audio = (0.2 * np.sin(2 * np.pi * 180.0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
             + 0.02 * rng.normal(0, 1, t.shape)).astype(np.float32)
    tokens, launches = {}, {}
    for flash in ("auto", "off"):
        engine = WhisperEngine("small", device=cuda_device, compute_type="float32",
                               flash_attention=flash, max_decode_tokens=64)
        try:
            before = flash_attention.launches
            out = engine.transcribe_sync(DecodeRequest(audio, language="en"))
            launches[flash] = flash_attention.launches - before
        finally:
            engine.close()
        tokens[flash] = out._tokens[out._p_len: out._p_len + out._n_gen].tolist()
    assert launches == {"auto": 12, "off": 0}
    assert tokens["auto"] == tokens["off"] and len(tokens["auto"]) > 0


# -- decode graphs ------------------------------------------------------------------
#
# The engine serves the greedy decode by replaying a captured CUDA graph of
# `_decode_chunk` per shape (stt_tpu_torch/engine/graphs.py). The replay runs
# the kernels the uncaptured chunk launches, in the same order, on the same
# buffers, so the two must agree bit for bit.


def _graph_audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f0 = 120.0 + 35.0 * seed + 25.0 * np.sin(2 * np.pi * 0.5 * t)
    sig = 0.2 * np.sin(2 * np.pi * np.cumsum(f0) / 16000.0)
    return (sig + 0.02 * rng.normal(0, 1, t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def graph_engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from stt_tpu_torch.engine.engine import WhisperEngine

    engines = {
        "int8": WhisperEngine("small", device="cuda", compute_type="bfloat16",
                              batch_buckets=(1, 4, 16)),
        "fp8": WhisperEngine("small", device="cuda", compute_type="bfloat16",
                             batch_buckets=(1, 4, 16), cross_kv_dtype="fp8", xattn_kernel="mm",
                             flash_attention="auto"),
        "float32": WhisperEngine("small", device="cuda", compute_type="float32",
                                 batch_buckets=(1, 4, 16)),
    }
    yield engines
    for engine in engines.values():
        engine.close()


def _decode_both(engine, seconds, rows):
    """One group of ``rows`` requests of ``seconds`` decoded on its entry by
    replaying the graph and by the same chunk uncaptured."""
    from stt_tpu_torch.engine import engine as E
    from stt_tpu_torch.models import whisper as W

    bucket = engine._bucket_for(int(seconds * 16000))
    pcm = np.zeros((rows, int(bucket * 16000)), np.int16)
    for i in range(rows):
        audio = _graph_audio(seconds * (0.5 + 0.5 * (i + 1) / rows), seed=i)
        pcm[i, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    prompt = torch.tensor([W.build_prompt(engine.config, "en")] * rows, device="cuda")
    auto = torch.arange(rows, device="cuda") % 2 == 1
    with torch.inference_mode():
        rows_dev = torch.from_numpy(E._encode_wire_rows(pcm, engine.audio_wire)).cuda()
        enc = E._mel_encode(engine.model, rows_dev, engine._dtype)
        entry = engine.graphs.entry(bucket, rows, prompt.shape[1],
                                    engine._max_new_for(bucket), enc.shape[1])
        ckv = W.precompute_cross_kv(engine.model.decoder, enc, out=entry.cross_kv)
        prompt, _, _ = E._detect_and_patch_lang(engine.model, enc, prompt, auto, ckv, 1)
        plen = torch.full((rows,), prompt.shape[1], device="cuda")
        return entry, [engine.graphs.decode(entry, prompt, plen, captured=c)
                       for c in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy,rows,seconds",
                         [("int8", r, s) for r in (1, 4, 16) for s in (1.0, 10.0, 30.0)]
                         + [("fp8", 4, 30.0), ("fp8", 16, 10.0), ("float32", 4, 10.0),
                            ("float32", 1, 30.0)])
def test_captured_decode_is_bitwise_the_uncaptured_one(graph_engines, policy, rows, seconds):
    engine = graph_engines[policy]
    replays = engine.graph_replays
    entry, (captured, eager) = _decode_both(engine, seconds, rows)
    torch.cuda.synchronize()
    assert entry.graph is not None and entry.replays > 0
    assert engine.graph_replays > replays
    assert torch.equal(captured.tokens, eager.tokens)
    assert torch.equal(captured.lengths, eager.lengths)
    assert torch.equal(captured.sum_logprob, eager.sum_logprob)
    assert torch.equal(captured.no_speech_prob, eager.no_speech_prob)
    assert torch.isfinite(captured.sum_logprob).all()
    if policy == "fp8":  # the cross-attention kernel runs inside the graph
        assert entry.launches["xattn_decode"] == 12 * 8
    else:
        assert entry.launches["xattn_decode"] == 0


@pytest.fixture
def serving_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from stt_tpu_torch.engine.engine import WhisperEngine

    engine = WhisperEngine("small", device="cuda", compute_type="bfloat16",
                           batch_buckets=(1, 4), max_batch=1, batch_window_ms=0.0,
                           pipeline_depth=2, max_decode_tokens=64)
    yield engine
    engine.close()


@pytest.mark.cuda
def test_pipelined_groups_of_one_shape_keep_their_own_tokens(serving_engine):
    """Groups of one shape queued back to back, two in flight, each replay
    the shape's graph before the one before it is harvested; each request
    still gets the tokens it gets alone."""
    from stt_tpu_torch.engine.engine import DecodeRequest

    engine = serving_engine
    engine.prewarm([2.0], [1])
    requests = [DecodeRequest(_graph_audio(1.5, seed=10 + i), language="en") for i in range(6)]
    alone = [engine.transcribe_sync(r)._tokens.tolist() for r in requests]
    assert len({tuple(t) for t in alone}) > 1
    futures = [engine.submit(r) for r in requests]
    served = [f.result(timeout=300) for f in futures]
    assert [o._tokens.tolist() for o in served] == alone
    assert max(o.batch_rows for o in served) == 1


@pytest.mark.cuda
def test_prewarmed_shapes_capture_nothing_when_served(serving_engine):
    from stt_tpu_torch.engine.engine import DecodeRequest

    engine = serving_engine
    engine.max_batch = 4
    engine.prewarm([1.0, 2.0], [1, 4])
    captures, replays = engine.graph_captures, engine.graph_replays
    assert captures == 4
    futures = [engine.submit(DecodeRequest(_graph_audio(0.6 + 0.25 * i, seed=i), language=None))
               for i in range(6)]
    for f in futures:
        f.result(timeout=300)
    assert engine.graph_captures == captures
    assert engine.graph_replays > replays


@pytest.mark.cuda
def test_unwarmed_shape_is_captured_once_then_reused(serving_engine):
    from stt_tpu_torch.engine.engine import DecodeRequest

    engine = serving_engine
    assert engine.graph_captures == 0
    request = DecodeRequest(_graph_audio(4.0, seed=3), language="en")
    first = engine.transcribe_sync(request)
    assert engine.graph_captures == 1 and len(engine.graphs) == 1
    replays = engine.graph_replays
    again = engine.transcribe_sync(request)
    assert engine.graph_captures == 1 and engine.graph_replays > replays
    assert again._tokens.tolist() == first._tokens.tolist()
