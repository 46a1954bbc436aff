"""The float32 flash-attention body's plan, held on the CPU.

The CUDA body ``flash_attention_f32_kernel`` in
``stt_tpu_torch/ops/cuda/flash_attention.cu`` cannot run here, so this file
holds a Python model of it, step for step, and the split planner that the
wrapper hands it:

- blocks of 128 query rows, the Q tile and every 64-key K/V tile
  zero-filled past T; scores summed over d in order, keys >= T scored
  -inf; per tile the row max, ``alpha = exp(m_old - m_new)`` rescaling the
  running sum and the output rows, p = exp(s - m_new);
- each row's sum kept as 8 lane shares (lane tx holds keys tx + 8j of
  every tile, added in the order of j) and folded by the xor butterfly of
  the shuffles at the end;
- O += P V from the [key][row] P tile, key by key in order;
- with the keys split over a cluster, each block's contiguous range of
  tiles, then the combine in rank order: M = max m_r, L = sum l_r exp(m_r -
  M), O = sum O_r exp(m_r - M), one division O / L.

In float32 the model equals the port's plain version and the JAX
package's ``_attention`` with flash off at atol 1e-5 / rtol 1e-5, the
kernel's own limit on the card (nothing is rounded below float32, so the
three differ only in the order of float32 sums). The kernel is held to the
plain version on the card in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu_torch.ops.kernels import flash_attention as FA
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-5
ROWS, KEYS, LANES = FA.F32_ROWS, FA.F32_KEYS, 8


def _ceil(a, b):
    return -(-a // b)


def _padded(x, n):
    out = np.zeros((x.shape[0], n, x.shape[2]), np.float32)
    out[:, : x.shape[1]] = x
    return out


def kernel_model(q, k, v, splits):
    """The float32 body on (B*H, T, Dh) float32 q/k/v (q and k pre-scaled)
    with ``splits`` blocks per query block -> (B*H, T, Dh) float32."""
    bh, t, dh = q.shape
    n_q, n_tiles = _ceil(t, ROWS), _ceil(t, KEYS)
    per = _ceil(n_tiles, splits)
    qb = _padded(q, n_q * ROWS).reshape(bh, n_q, ROWS, dh)
    kp, vp = _padded(k, n_tiles * KEYS), _padded(v, n_tiles * KEYS)
    lane = np.arange(LANES)
    parts = []
    for rank in range(splits):
        first, last = rank * per, min(n_tiles, (rank + 1) * per)
        assert first < last, "the planner gave a block no key tile"
        m = np.full((bh, n_q, ROWS), -np.inf, np.float32)
        shares = np.zeros((bh, n_q, ROWS, LANES), np.float32)
        acc = np.zeros((bh, n_q, ROWS, dh), np.float32)
        for i in range(first, last):
            kt, vt = kp[:, i * KEYS:(i + 1) * KEYS], vp[:, i * KEYS:(i + 1) * KEYS]
            s = np.zeros((bh, n_q, ROWS, KEYS), np.float32)
            for d in range(dh):
                s = s + qb[..., d, None] * kt[:, None, None, :, d]
            s[..., i * KEYS + np.arange(KEYS) >= t] = -np.inf
            m_new = np.maximum(m, s.max(-1))
            alpha = np.exp(m - m_new)
            m = m_new
            shares = shares * alpha[..., None]
            acc = acc * alpha[..., None]
            p = np.exp(s - m_new[..., None])
            by_lane = p.reshape(bh, n_q, ROWS, KEYS // LANES, LANES)
            for j in range(KEYS // LANES):
                shares = shares + by_lane[..., j, :]
            p_tile = np.swapaxes(p, -1, -2)  # [key][row]
            for c in range(KEYS):
                acc = acc + p_tile[..., c, :, None] * vt[:, None, None, c, :]
        for off in (1, 2, 4):
            shares = shares + shares[..., lane ^ off]
        parts.append((m, shares[..., 0], acc))
    if splits == 1:
        m, l, acc = parts[0]
        out = acc / l[..., None]
    else:
        top = parts[0][0]
        for m, _, _ in parts[1:]:
            top = np.maximum(top, m)
        total = np.zeros_like(top)
        mixed = np.zeros_like(parts[0][2])
        for m, l, acc in parts:
            w = np.exp(m - top)
            total = l * w + total
            mixed = acc * w[..., None] + mixed
        out = mixed / total[..., None]
    assert out.dtype == np.float32
    return out.reshape(bh, n_q * ROWS, dh)[:, :t]


def _valid_splits(t):
    n_tiles = _ceil(t, KEYS)
    return [s for s in range(1, min(FA.F32_MAX_SPLIT, n_tiles) + 1)
            if _ceil(n_tiles, _ceil(n_tiles, s)) == s]


def _inputs(b, h, t, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, t, h * dh)).astype(np.float32) for _ in range(3)]


def _heads(x, h, scale):
    b, t, d = x.shape
    return (x.reshape(b, t, h, d // h).transpose(0, 2, 1, 3) * np.float32(scale)) \
        .reshape(b * h, t, d // h)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 333, 600])
def test_model_matches_plain_and_jax(monkeypatch, dh, t):
    """Every split count the kernel accepts at this T (the planner's pick
    among them), against both references. T 65 leaves one key in the last
    tile; 63 and 333 leave ragged query and key tiles."""
    b, h = 1, 2
    x = _inputs(b, h, t, dh, seed=dh + t)
    monkeypatch.setattr(JW, "FLASH_ATTENTION", "off")
    ref_jax = np.asarray(JW._attention(*(jnp.asarray(a) for a in x), h), np.float32)
    ref_jax = ref_jax.reshape(b, t, h, dh).transpose(0, 2, 1, 3).reshape(b * h, t, dh)
    scale = dh ** -0.25
    q, k = _heads(x[0], h, scale), _heads(x[1], h, scale)
    v = _heads(x[2], h, 1.0)
    ref = FA.flash_attention_plain(*(torch.from_numpy(a)[None] for a in (q, k, v)))[0].numpy()
    splits = _valid_splits(t)
    assert FA.plan_f32(b * h, t) in splits
    for s in splits:
        got = kernel_model(q, k, v, s)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=f"{s} splits")
        np.testing.assert_allclose(got, ref_jax, atol=ATOL, rtol=RTOL, err_msg=f"{s} splits")


@pytest.mark.parametrize("rows,splits,waves", [
    (1, 3, 1.6363636363636365), (4, 2, 4.363636363636363),
    (16, 1, 8.727272727272727), (64, 1, 34.90909090909091),
])
def test_planner_at_served_shapes(rows, splits, waves):
    """The served float32 path: 12 heads x 1500 positions at the row
    buckets 1/4/16/64. Unsplit, 1 row is 144 blocks of 128 rows on 132 SMs
    (12 SMs run 2 blocks while 120 run one alone) and 4 rows 576 (4.36 a
    SM); split 3 and 2 ways they load every SM within one block of the
    others. 16 and 64 rows (17.5 and 69.8 blocks a SM) gain nothing."""
    bh = rows * 12
    assert FA.plan_f32(bh, 1500) == splits
    assert FA.f32_waves(bh, 1500, splits) == pytest.approx(waves)
    assert FA.f32_waves(bh, 1500, 1) == pytest.approx(waves / splits)


@pytest.mark.parametrize("t", [1, 64, 65, 129, 333, 512, 600, 1499, 1500, 3000])
@pytest.mark.parametrize("bh", [1, 2, 12, 48, 192, 512, 768, 65535])
def test_planner_gives_every_block_a_tile(bh, t):
    """Within the cluster's portable size, every block of a split gets at
    least one key tile (the launcher refuses a split that does not), and a
    grid of 8 waves or more is never split."""
    s = FA.plan_f32(bh, t)
    assert s in _valid_splits(t)
    assert 1 <= s <= FA.F32_MAX_SPLIT
    if FA.f32_waves(bh, t, 1) >= 8:
        assert s == 1


def test_planner_rejects_empty_work():
    with pytest.raises(ValueError):
        FA.plan_f32(0, 1500)
    with pytest.raises(ValueError):
        FA.plan_f32(12, 0)
