"""The port's flash backward against the TPU's Pallas backward kernels.

``stt_tpu.models.whisper._flash_self_attention`` reaches the library flash
attention (``jax.experimental.pallas.ops.tpu.flash_attention``), whose
gradient runs the Pallas bodies that ``flash_attention_bwd.cu`` replaces:
``_flash_attention_dkv_kernel`` (dK, dV) and ``_flash_attention_dq_kernel``
(dQ). On the CPU they run interpreted, under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``, with the JAX
package's own padding of T to 128 and the segment ids that mask the pad.
Called directly: ``_attention`` takes the einsum path on the CPU.

The port's side is ``torch.autograd.grad`` through ``FA.flash_attention``
(the autograd Function: plain forward with its log-sum-exp, then the plain
versions of the dK/dV and dQ kernels, which round P and dS to the input
type before their products as those bodies do). Both take the same
numpy-seeded pre-scaled q, k, v and upstream gradient, at B 1, H 2, T 300
(ragged: the JAX side pads it to 384) and T 256, Dh 64 and 32. Bars, of
each gradient's largest |value|: float32 1e-5 (float32 sums in another
order; measured up to ~8e-7), bf16 2e-2 (one rounding of P, dS and the
gradient to bf16 on each side; measured up to ~8e-3). The card's kernels
are held against the same plain versions in
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stt_tpu.models import whisper as JW
from stt_tpu_torch.ops.kernels import flash_attention as FA
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

B, H = 1, 2
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(t: int, dh: int, seed: int):
    """Pre-scaled (B, H, T, Dh) q, k (d_head**-0.25 each), v and dO."""
    rng = np.random.default_rng(seed)
    scale = dh ** -0.25
    q, k = (rng.normal(0, 1, (B, H, t, dh)) * scale for _ in range(2))
    v, g = (rng.normal(0, 1, (B, H, t, dh)) for _ in range(2))
    return [x.astype(np.float32) for x in (q, k, v, g)]


def _pallas_grads(arrays, dtype):
    """jax.grad through the JAX package's flash attention, its Pallas
    forward and backward kernels interpreted on the CPU."""
    jq, jk, jv, jg = (jnp.asarray(a, JNP[dtype]) for a in arrays)

    def f(a, b, c):
        out = JW._flash_self_attention(a, b, c, sm_scale=1.0)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dh", [(300, 64), (300, 32), (256, 64), (256, 32)])
def test_backward_matches_the_pallas_backward_kernels(t, dh, dtype):
    arrays = _inputs(t, dh, seed=t + dh)
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays[:3])
    g = torch.from_numpy(arrays[3]).to(dtype)
    out = FA.flash_attention(q, k, v)
    assert "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = _pallas_grads(arrays, dtype)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == (B, H, t, dh), name
        err = float(np.abs(a.float().numpy() - r).max() / np.abs(r).max())
        assert err < TOL[dtype], (name, err)
