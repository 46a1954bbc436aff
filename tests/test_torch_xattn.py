"""The port's cross-attention decode path against the JAX package's, on the CPU.

- The port's ``xattn_decode`` wrapper (its plain version on a CPU tensor)
  against the JAX ``xattn_decode(..., interpret=True, variant="mm")`` and
  against ``_attn_cached`` for bf16 and fp8 K/V, at rtol/atol 2e-2 (the
  tolerance and shapes of ``tests/test_xattn_decode.py``): both sides round
  the softmax weights to bf16, and the JAX interpret-mode kernel sums in
  another order.
- The int8 branch of ``_cross_layer_attn`` with the kernel route on (scales
  folded into q and the output, the codes only converted) against the JAX
  int8 einsum branch, at the same tolerance.
- The attention policy: every value each JAX option takes, the defaults,
  and the environment read once when the engine is built.
- The fp8 cast: torch's bf16 -> e4m3 cast equals JAX's bit for bit on every
  finite bf16 with |x| <= 464; beyond that torch saturates to ±448 where
  JAX gives NaN, a reference behaviour the port does not copy.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stt_tpu.models import whisper as JW
from stt_tpu.ops.pallas.xattn_decode import xattn_decode as jax_xattn_decode
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from stt_tpu_torch.ops.kernels import xattn_decode as XK
from stt_tpu_torch.ops.kernels.xattn_decode import xattn_decode, xattn_decode_plain
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-2
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _inputs(name, b=3, h=4, ta=40, dh=16, seed=0):
    """The same bf16 q and K/V in both frameworks, K/V cast to the storage
    type by each framework's own cast (they agree in this range)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32)
    jdt, tdt = DTYPES[name]
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jk, jv = (jnp.asarray(x).astype(jnp.bfloat16).astype(jdt) for x in (k, v))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16).to(tdt) for x in (k, v))
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("reference", ["pallas_mm_interpret", "attn_cached"])
@pytest.mark.parametrize("name", ["bf16", "fp8"])
def test_xattn_matches_jax(name, reference):
    (jq, jk, jv), (tq, tk, tv) = _inputs(name)
    assert np.array_equal(np.asarray(jk.astype(jnp.float32)), tk.float().numpy())
    if reference == "pallas_mm_interpret":
        ref = np.asarray(jax_xattn_decode(jq, jk, jv, interpret=True, variant="mm"))
    else:
        ref = np.asarray(JW._attn_cached(jq[:, :, None, :], jk, jv)[:, :, 0, :])
    before = xattn_decode.launches
    got = xattn_decode(tq, tk, tv)
    assert xattn_decode.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (3, 4, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), xattn_decode_plain(tq, tk, tv).numpy())


def test_xattn_float32_storage_rounds_to_bf16():
    """float32 compute keeps float32 K/V; the kernel, like the TPU ``mm``
    body, rounds q and K/V to bf16 on load."""
    (_, jk, jv), (tq, tk, tv) = _inputs("bf16")
    got = xattn_decode(tq.float(), tk.float(), tv.float())
    np.testing.assert_array_equal(got.numpy(), xattn_decode(tq, tk, tv).numpy())
    jq = jnp.asarray(tq.float().numpy())
    ref = np.asarray(jax_xattn_decode(jq, jk.astype(jnp.float32), jv.astype(jnp.float32),
                                      interpret=True, variant="mm"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def _int8_cross_kv(k, v):
    """(1, B, H, Ta, Dh) int8 codes and (1, B, H, 1, 1) scales, computed once
    in numpy and handed to both frameworks."""
    def q8(x):
        s = np.maximum(np.abs(x).max(axis=(2, 3), keepdims=True) / 127.0, 1e-12)
        return np.round(x / s).astype(np.int8)[None], s.astype(np.float32)[None]

    (kq, ks), (vq, vs) = q8(k), q8(v)
    jax_ckv = JW.CrossKV(*(jnp.asarray(a) for a in (kq, vq, ks, vs)))
    torch_ckv = TW.CrossKV(*(torch.from_numpy(a) for a in (kq, vq, ks, vs)))
    return jax_ckv, torch_ckv


@pytest.mark.parametrize("zero_row", [False, True])
def test_int8_folded_branch_matches_jax(zero_row):
    rng = np.random.default_rng(5)
    b, h, ta, dh = 3, 4, 40, 16
    k = rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, ta, dh)).astype(np.float32)
    if zero_row:  # an all-zero (row, head) gets the 1e-12 floor scale
        k[1, 2] = 0.0
        v[1, 2] = 0.0
    q = rng.normal(0, 1, (b, h, 1, dh)).astype(np.float32)
    jax_ckv, torch_ckv = _int8_cross_kv(k, v)
    ref = np.asarray(JW._cross_layer_attn(jnp.asarray(q).astype(jnp.bfloat16), jax_ckv, 0))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = TW._cross_layer_attn(tq, torch_ckv, 0, kernel=True)
    einsum = TW._cross_layer_attn(tq, torch_ckv, 0, kernel=False)
    assert got.shape == einsum.shape == (b, h, 1, dh) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), einsum.numpy(), rtol=TOL, atol=TOL)


def _jax_store_name(dtype):
    return {None: None, jnp.int8: "int8", jnp.float8_e4m3fn: "fp8"}[dtype]


def _torch_store_name(dtype):
    return {None: None, torch.int8: "int8", torch.float8_e4m3fn: "fp8"}[dtype]


@pytest.mark.parametrize("value", ["fp8", "f8", "float8", "fp8_e4m3", " FP8 ", "int8", "i8",
                                   "INT8", "bf16", "bfloat16", "none", "", "float32"])
def test_cross_kv_dtype_values_match_jax(monkeypatch, value):
    policy = TW.AttentionPolicy(cross_kv_dtype=value)
    monkeypatch.setattr(JW, "CROSS_KV_DTYPE", value.strip().lower())
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        assert _torch_store_name(policy.cross_store_dtype(tdt)) == \
            _jax_store_name(JW._cross_store_dtype(jdt))


@pytest.mark.parametrize("value,on", [("off", False), ("0", False), ("false", False),
                                      (" Off ", False), ("mm", True), ("auto", True),
                                      ("on", True), ("1", True), ("vpu", True)])
def test_xattn_kernel_values(value, on):
    assert TW.AttentionPolicy(xattn_kernel=value).xattn_on is on


@pytest.mark.parametrize("value", ["off", "OFF", "auto", "on", "0", "false"])
def test_flash_attention_values(value):
    policy = TW.AttentionPolicy(flash_attention=value)
    on = value.lower() != "off"  # as the JAX package: only "off" is off
    assert policy.flash_on(TW.FLASH_MIN_SEQ) is on
    assert policy.flash_on(1500) is on
    assert policy.flash_on(TW.FLASH_MIN_SEQ - 1) is False


def test_policy_defaults(monkeypatch):
    for var, _ in TW.POLICY_ENV.values():
        monkeypatch.delenv(var, raising=False)
    default = TW.AttentionPolicy("int8", "off", "off")
    assert TW.AttentionPolicy() == default
    assert TW.AttentionPolicy.from_env() == default
    assert TW.FLASH_MIN_SEQ == JW._FLASH_MIN_SEQ
    assert default.cross_store_dtype(torch.bfloat16) == torch.int8
    with pytest.raises(TypeError):
        TW.AttentionPolicy.from_env(flash="auto")


def test_engine_reads_environment_once(monkeypatch):
    monkeypatch.setenv("STT_CROSS_KV_DTYPE", "fp8")
    monkeypatch.setenv("STT_XATTN_KERNEL", "mm")
    monkeypatch.setenv("STT_FLASH_ATTENTION", "auto")
    eng = TE.WhisperEngine("test", device="cpu", compute_type="bfloat16")
    expected = TW.AttentionPolicy("fp8", "mm", "auto")
    assert eng.policy == expected
    assert eng.model.encoder.policy == eng.model.decoder.policy == expected
    monkeypatch.setenv("STT_CROSS_KV_DTYPE", "int8")
    assert eng.model.decoder.policy == expected  # read once, at build
    given = TE.WhisperEngine("test", device="cpu", compute_type="bfloat16",
                             cross_kv_dtype="bf16", xattn_kernel="off")
    assert given.policy == TW.AttentionPolicy("bf16", "off", "auto")
    monkeypatch.delenv("STT_CROSS_KV_DTYPE")
    monkeypatch.delenv("STT_XATTN_KERNEL")
    monkeypatch.delenv("STT_FLASH_ATTENTION")
    assert TE.WhisperEngine("test", device="cpu").policy == TW.AttentionPolicy()


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    return bits.view(ml_dtypes.bfloat16), torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def test_fp8_cast_matches_jax_within_range():
    """Every finite bf16 with |x| <= 464 (subnormals, ±0 and the 16 values
    in (448, 464] included) casts to the same e4m3 bits in both."""
    np_bf16, t_bf16 = _all_bf16()
    x = np_bf16.astype(np.float32)
    keep = np.isfinite(x) & (np.abs(x) <= 464.0)
    j_bits = np.asarray(jnp.asarray(np_bf16).astype(jnp.float8_e4m3fn)).view(np.uint8)
    t_bits = t_bf16.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert keep.sum() == 34754 + 16
    np.testing.assert_array_equal(t_bits[keep], j_bits[keep])


def test_fp8_cast_beyond_range_saturates_where_jax_gives_nan():
    np_bf16, t_bf16 = _all_bf16()
    x = np_bf16.astype(np.float32)
    over = np.isfinite(x) & (np.abs(x) > 464.0)
    assert over.any()
    j = np.asarray(jnp.asarray(np_bf16).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    t = t_bf16.to(torch.float8_e4m3fn).float().numpy()
    assert np.isnan(j[over]).all()
    np.testing.assert_array_equal(t[over], np.sign(x[over]) * 448.0)
    samples = torch.tensor([470.0, 500.0, -1000.0], dtype=torch.bfloat16)
    assert samples.to(torch.float8_e4m3fn).float().tolist() == [448.0, 448.0, -448.0]


@pytest.mark.parametrize("bh,ta", [(48, 1500), (192, 1500), (768, 500), (12, 50), (1, 1),
                                   (96, 1500), (24, 333), (12, 20000), (2, 70000),
                                   (1, 131072), (5000, 7), (3, 8193)])
@pytest.mark.parametrize("dh,itemsize", [(64, 1), (64, 2), (64, 4), (32, 1), (16, 2)])
def test_split_plan_covers_ta_within_limits(bh, ta, dh, itemsize):
    """The cross-attention-decode planner: the chunks cover Ta exactly, with
    no chunk past the end; the cluster is a power of two within the
    hardware's limit (portable unless Ta needs more); each chunk's scores fit
    the block's shared memory; splitting stops once the grid has two
    blocks per SM."""
    clusters, chunk = XK.plan_split(bh, ta, dh, itemsize)
    assert 1 <= clusters <= XK.CLUSTER_MAX and clusters & (clusters - 1) == 0
    assert (clusters - 1) * chunk < ta <= clusters * chunk
    assert 1 <= chunk <= XK.CHUNK_MAX
    if ta <= XK.CLUSTER_PORTABLE * XK.CHUNK_MAX:
        assert clusters <= XK.CLUSTER_PORTABLE
    if clusters > 1 and ta <= clusters // 2 * XK.CHUNK_MAX:  # split for the grid, not length
        assert bh * clusters // 2 < 2 * XK.H100_SMS
        assert -(-ta // clusters) >= XK.rows_per_pass(dh, itemsize)


def test_split_plan_served_shapes_and_limit():
    assert XK.plan_split(4 * 12, 1500, 64, 1) == (8, 188)     # the served 30 s decode
    assert XK.plan_split(64 * 12, 500, 64, 1) == (1, 500)     # a full batch needs no split
    assert XK.MAX_TA == XK.CLUSTER_MAX * XK.CHUNK_MAX == 131072
    with pytest.raises(ValueError):
        XK.plan_split(1, XK.MAX_TA + 1, 64, 2)
