"""The flash attention's backward in the port against the JAX package's.

On the CPU the autograd Function around ``flash_attention`` takes the plain
forward (with its log-sum-exp) and the plain backward
(``flash_attention_backward_plain``, the plain versions of the dK/dV and dQ
kernels). They are held against ``jax.grad`` of the JAX package's
``_attention`` and against the library's own reference backward
(``mha_reference_bwd``, the custom VJP the Pallas backward kernels stand in
for), at B 2, H 2, T 600, Dh 64: float32 within 1e-5 of the largest
|gradient|, bf16 within 2e-2 of it (both sides round the gradients to bf16
from float32 sums in another order). The card's kernels are held against
the same plain backward in ``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as LIB

from stt_tpu.models import whisper as JW
from stt_tpu_torch.models import whisper as W
from stt_tpu_torch.ops.kernels import flash_attention as FA
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

B, H, T, DH = 2, 2, 600, 64
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _heads(seed: int, dtype: torch.dtype):
    """Pre-scaled (B, H, T, Dh) q, k, v and an upstream gradient, from numpy."""
    rng = np.random.default_rng(seed)
    scale = DH ** -0.25
    q, k = (rng.normal(0, 1, (B, H, T, DH)) * scale for _ in range(2))
    v, g = (rng.normal(0, 1, (B, H, T, DH)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.float32)).to(dtype) for x in (q, k, v, g)]


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32)) if not isinstance(ref, torch.Tensor) \
        else ref.float().numpy()
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_the_library_reference_backward(dtype):
    """flash_attention_backward_plain against ``mha_reference_bwd`` given
    the same forward residuals (lse = m + log l)."""
    q, k, v, g = _heads(1, dtype)
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), JNP[dtype]) for x in (q, k, v, g))
    out, l, m = LIB.mha_reference_no_custom_vjp(jq, jk, jv, None, None, save_residuals=True)
    ref = LIB.mha_reference_bwd(jq, jk, jv, None, None, out, l, m, jg)
    lse = torch.from_numpy(np.array(m + jnp.log(l), np.float32))
    got = FA.flash_attention_backward_plain(
        q, k, v, torch.from_numpy(np.array(out.astype(jnp.float32))).to(dtype), lse, g)
    for name, a, r in zip("qkv", got, ref[:3]):
        assert a.dtype == dtype
        assert _rel(a, r) < TOL[dtype], (name, _rel(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_grad_matches_jax_grad(dtype):
    """Autograd through the port's ``_attention`` with flash on (the
    Function: plain forward and plain backward on the CPU) against
    ``jax.grad`` of the JAX package's ``_attention`` (einsum), on the
    merged (B, T, H*Dh) inputs, scale included."""
    rng = np.random.default_rng(2)
    d = H * DH
    arrays = [rng.normal(0, 1, (B, T, d)).astype(np.float32) for _ in range(4)]
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    for x in (q, k, v):
        x.requires_grad_(True)
    out = W._attention(q, k, v, H, flash=True)
    got = torch.autograd.grad(out, (q, k, v), g)

    jq, jk, jv, jg = (jnp.asarray(a, JNP[dtype]) for a in arrays)

    def f(a, b, c):
        return jnp.sum(JW._attention(a, b, c, H).astype(jnp.float32) * jg.astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for name, a, r in zip("qkv", got, ref):
        assert _rel(a, r) < TOL[dtype], (name, _rel(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_log_sum_exp_matches_torch(dtype):
    q, k, _, _ = _heads(3, dtype)
    v = _heads(4, dtype)[2]
    out, lse = FA.flash_attention_with_lse(q, k, v)
    ref = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(out, FA.flash_attention_plain(q, k, v), atol=0, rtol=0)


def test_autograd_function_equals_autograd_through_the_plain_forward():
    """On the CPU the Function's gradients are autograd's through
    ``flash_attention_plain`` (float32: same math, other summation order)."""
    q, k, v, g = _heads(5, torch.float32)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = FA.flash_attention(*a)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, a, g)
    ref = torch.autograd.grad(FA.flash_attention_plain(*b), b, g)
    for x, r in zip(got, ref):
        assert _rel(x, r) < 1e-5
    torch.testing.assert_close(out, FA.flash_attention_plain(q, k, v), atol=0, rtol=0)


def test_without_grad_the_wrapper_returns_no_graph():
    q, k, v, _ = _heads(6, torch.float32)
    with torch.no_grad():
        assert FA.flash_attention(*(x.requires_grad_(True) for x in (q, k, v))).grad_fn is None


def test_backward_wrappers_check_their_residuals():
    q, k, v, g = _heads(7, torch.float32)
    lse = torch.zeros(B, H, T)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_dkv(q, k, v, g, lse[..., :-1], lse)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_dq(q, k, v, g, lse.double(), lse)
    with pytest.raises(TypeError):
        FA.flash_attention_bwd_dq(q.half(), k.half(), v.half(), g.half(), lse, lse)
