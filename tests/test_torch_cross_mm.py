"""The int8-operand cross-attention products (``ops/kernels/cross_mm.py``)
on the CPU: the plain versions against ``_attn_cached``, the split plans,
the route that takes them and the wrappers' checks. The kernels themselves
run in ``tests/test_torch_kernels_cuda.py`` on the card."""

from types import SimpleNamespace

import pytest
import torch

from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.ops.kernels import cross_mm as X

DH = 64


def _codes(b, h, ta, seed=0):
    """q (B, H, 1, Dh) bf16 with an int8 scale of K folded in, and K/V codes
    (B, H, Ta, Dh) int8 over the whole range, as precompute_cross_kv stores
    them."""
    gen = torch.Generator().manual_seed(seed)
    scale = DH ** -0.25
    k_scale = 3.5 * scale / 127.0  # |k| reaches ~3.5 sigma of its row and head
    q = (torch.randn((b, h, 1, DH), generator=gen) * scale * k_scale).to(torch.bfloat16)
    k = torch.randint(-127, 128, (b, h, ta, DH), generator=gen, dtype=torch.int8)
    v = torch.randint(-127, 128, (b, h, ta, DH), generator=gen, dtype=torch.int8)
    return q, k, v


@pytest.mark.parametrize("h", [12, 20])
@pytest.mark.parametrize("b", [1, 4, 64])
@pytest.mark.parametrize("ta", [50, 100, 250, 500, 1500])
def test_plain_pair_is_attn_cached_on_int8_codes(b, h, ta):
    """The plain versions with torch's softmax between them compute
    ``_attn_cached`` over the codes bit for bit on the CPU."""
    q, k, v = _codes(b, h, ta, seed=b * 7 + h + ta)
    logits = X.cross_logits_plain(q[:, :, 0, :], k)
    assert logits.shape == (b, h, ta) and logits.dtype == torch.float32
    got = X.cross_mix_plain(torch.softmax(logits, dim=-1), v)
    assert got.shape == (b, h, DH) and got.dtype == torch.float32
    assert torch.equal(got, W._attn_cached(q, k, v)[:, :, 0, :])


def _cross_kv(b, h, ta, layers=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    scale = DH ** -0.25
    k, ks = W._q8(torch.randn((layers * b, h, ta, DH), generator=gen) * scale)
    v, vs = W._q8(torch.randn((layers * b, h, ta, DH), generator=gen))
    split = lambda x: x.reshape(layers, b, *x.shape[1:])  # noqa: E731
    ckv = W.CrossKV(split(k), split(v), split(ks), split(vs))
    qx = (torch.randn((b, h, 1, DH), generator=gen) * scale).to(torch.bfloat16)
    return qx, ckv


def _parent_cross_layer_attn(qx, ckv, li):
    """``_cross_layer_attn``'s einsum route as it was before the int8-code
    products: scales folded, the codes widened in ``_attn_cached``."""
    qx = qx * ckv.k_scale[li].to(qx.dtype)
    return W._attn_cached(qx, ckv.k[li], ckv.v[li]) * ckv.v_scale[li]


@pytest.mark.parametrize("b,ta", [(1, 50), (4, 250), (16, 1500)])
def test_cross_layer_attn_on_the_cpu_is_unchanged(b, ta):
    """On the CPU int8 storage at Tq = 1 gives the widening route's result
    bit for bit (the wrappers take their plain versions) and launches
    nothing."""
    qx, ckv = _cross_kv(b, 12, ta)
    before = (X.cross_logits.launches, X.cross_mix.launches)
    for li in range(2):
        got = W._cross_layer_attn(qx, ckv, li)
        assert torch.equal(got, _parent_cross_layer_attn(qx, ckv, li))
    assert (X.cross_logits.launches, X.cross_mix.launches) == before


@pytest.mark.parametrize("b,ta", [(1, 50), (4, 250), (16, 1500)])
def test_cross_layer_attn_through_the_code_products(monkeypatch, b, ta):
    """The route takes the code products on the CPU as on the card (the
    wrappers take their plain versions here): the layer's result is the
    widening route's, bit for bit, and both wrappers are called once."""
    qx, ckv = _cross_kv(b, 12, ta, seed=2)
    calls = []
    for name in ("cross_logits", "cross_mix"):
        fn = getattr(W, name)
        monkeypatch.setattr(W, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    got = W._cross_layer_attn(qx, ckv, 1)
    assert calls == ["cross_logits", "cross_mix"]
    assert got.shape == (b, 12, 1, DH)
    assert torch.equal(got, _parent_cross_layer_attn(qx, ckv, 1))


def _q(tq=1, device="cuda", requires_grad=False):
    """Stands in for q: the route reads its shape, device and grad flag."""
    return SimpleNamespace(shape=(4, 12, tq, DH), device=torch.device(device),
                           requires_grad=requires_grad)


@pytest.mark.parametrize("storage", [torch.int8, torch.float8_e4m3fn, torch.bfloat16,
                                     torch.float32])
@pytest.mark.parametrize("tq", [1, 2, 224])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("grad", [False, True])
def test_route_takes_the_code_products_only_for_int8_tq1_cuda_no_grad(storage, tq, device,
                                                                       grad):
    """The route takes the code products for int8 storage at Tq = 1 with
    nothing to record, on either device; the kernels launch only for CUDA
    tensors, since the wrappers give CPU ones to the plain versions
    (``test_wrappers_take_the_plain_version_on_the_cpu``)."""
    kh = torch.zeros((4, 12, 50, DH), dtype=storage)
    with torch.set_grad_enabled(grad):
        taken = W._reads_int8_codes(_q(tq, device, requires_grad=grad), kh)
    assert taken == (storage == torch.int8 and tq == 1 and not grad)


@pytest.mark.parametrize("compute,cross,xattn,sources", [
    (torch.bfloat16, "int8", "off", ("cross_mm",)),
    (torch.bfloat16, "int8", "mm", ("xattn_decode",)),
    (torch.bfloat16, "fp8", "off", ()),
    (torch.bfloat16, "fp8", "mm", ("xattn_decode",)),
    (torch.bfloat16, "bf16", "off", ()),
    (torch.float32, "int8", "off", ()),
])
def test_decode_sources_follow_the_route(compute, cross, xattn, sources):
    """The sources the engine's prewarm builds for the decode step are those
    of the kernels its route launches: the int8-code products only over int8
    storage on the einsum route (bfloat16 compute stores int8)."""
    policy = W.AttentionPolicy(cross_kv_dtype=cross, xattn_kernel=xattn)
    assert W.decode_sources(policy, compute) == sources


def test_route_under_grad_with_a_frozen_query():
    """Grad mode alone records nothing for a query that needs no grad."""
    kh = torch.zeros((4, 12, 50, DH), dtype=torch.int8)
    with torch.enable_grad():
        assert W._reads_int8_codes(_q(requires_grad=False), kh)
        assert not W._reads_int8_codes(_q(requires_grad=True), kh)


@pytest.mark.parametrize("bh,ta", [(1, 50), (12, 50), (12, 250), (12, 1500), (48, 1500),
                                   (192, 250), (192, 1500), (768, 250), (768, 1500),
                                   (240, 1500), (1280, 1500), (1, 70000), (3, 1)])
@pytest.mark.parametrize("sms", [132, 114])
def test_plans_fill_the_card_and_cover_every_key_once(bh, ta, sms):
    rows = X.rows_per_pass(DH)
    chunk = X.plan_logits(bh, ta, DH, sms)
    tiles = -(-ta // chunk)
    spans = [(r * chunk, min((r + 1) * chunk, ta)) for r in range(tiles)]
    assert spans[0][0] == 0 and spans[-1][1] == ta and all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # short blocks; two blocks an SM, or one more halving would leave a tile
    # under a pass of rows
    assert rows <= chunk <= X.AHEAD * rows
    assert bh * tiles >= 2 * sms or chunk // 2 < rows

    clusters, chunk = X.plan_mix(bh, ta, DH, sms)
    assert clusters in (1, 2, 4, 8) and clusters * chunk >= ta
    spans = [(min(r * chunk, ta), min((r + 1) * chunk, ta)) for r in range(clusters)]
    assert spans[0][0] == 0 and spans[-1][1] == ta
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # one block an SM (past it the cluster's exchange costs more than it
    # gains), or the portable cap, or a block would drop under a pass of rows
    assert (bh * clusters >= sms or clusters == X.CLUSTER_MAX
            or -(-ta // (2 * clusters)) < rows)


def test_plans_at_the_served_rungs():
    """whisper-small's 12 heads at the rungs 1/4/16/64 over the 5 s and 30 s
    buckets (250 and 1500 keys), on the H100's 132 SMs."""
    got = {(b, ta): (X.plan_logits(12 * b, ta, DH), X.plan_mix(12 * b, ta, DH))
           for b in (1, 4, 16, 64) for ta in (250, 1500)}
    assert got == {
        (1, 250): (64, (2, 125)), (1, 1500): (64, (8, 188)),
        (4, 250): (64, (2, 125)), (4, 1500): (256, (4, 375)),
        (16, 250): (128, (1, 250)), (16, 1500): (256, (1, 1500)),
        (64, 250): (256, (1, 250)), (64, 1500): (256, (1, 1500)),
    }


def test_plans_reject_empty_work():
    for plan in (X.plan_logits, X.plan_mix):
        with pytest.raises(ValueError):
            plan(0, 50, DH)
        with pytest.raises(ValueError):
            plan(12, 0, DH)


def test_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v = _codes(2, 12, 50)
    before = (X.cross_logits.launches, X.cross_mix.launches)
    logits = X.cross_logits(q[:, :, 0, :], k)
    assert torch.equal(logits, X.cross_logits_plain(q[:, :, 0, :], k))
    w = torch.softmax(logits, dim=-1)
    assert torch.equal(X.cross_mix(w, v), X.cross_mix_plain(w, v))
    assert (X.cross_logits.launches, X.cross_mix.launches) == before


def test_wrappers_give_shapes_on_meta():
    """Meta tensors (the card's route traced without a card) get empty
    results of the kernels' shapes and types, and launch nothing."""
    meta = torch.device("meta")
    q = torch.empty((3, 20, DH), dtype=torch.bfloat16, device=meta)
    k = torch.empty((3, 20, 250, DH), dtype=torch.int8, device=meta)
    before = (X.cross_logits.launches, X.cross_mix.launches)
    logits = X.cross_logits(q, k)
    out = X.cross_mix(logits, k)
    assert (logits.device, logits.shape, logits.dtype) == (meta, (3, 20, 250), torch.float32)
    assert (out.device, out.shape, out.dtype) == (meta, (3, 20, DH), torch.float32)
    assert (X.cross_logits.launches, X.cross_mix.launches) == before


def test_wrappers_reject_bad_input():
    q, k, v = _codes(2, 12, 50)
    q3 = q[:, :, 0, :]
    w = torch.zeros((2, 12, 50))
    with pytest.raises(TypeError):
        X.cross_logits(q3.float(), k)
    with pytest.raises(TypeError):
        X.cross_logits(q3, k.to(torch.bfloat16))
    with pytest.raises(TypeError):
        X.cross_mix(w.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        X.cross_logits(q3[:1], k)
    with pytest.raises(ValueError):
        X.cross_logits(q, k)
    with pytest.raises(ValueError):
        X.cross_mix(w[..., :49], v)
    with pytest.raises(ValueError):
        X.cross_mix(w, v[0])
