"""K6, the delay predictor's attention: the port's plain versions vs the JAX package.

``flash_attention_kv`` on CPU tensors runs the plain forward and the plain split backward
(the formulas of ``csrc/flash_kv.cu``, query-chunked). They are held to the Pallas kernel
in interpret mode (forward, lse and ``jax.vjp``, with the default fused backward and under
``W2VHS_FLASHKV_SPLIT_BWD=1``, at T = 300 with 128-row blocks, so the padding and the
``col < t`` mask are exercised) and to ``_chunked_attention`` (T = 700: two query chunks).
Bars as ``tests/test_pallas_flash_kv.py``: atol 3e-5 in float32 (sums in other orders),
2e-2 across the bfloat16 boundary cast (one bf16 ulp at unit scale is 7.8e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.beamformer import _chunked_attention
from wav2vec_heart_sounds_tpu.ops.pallas import flash_kv as jax_flash_kv
from wav2vec_heart_sounds_tpu_torch.ops.kernels import flash_kv


def _qkv(b, t, h, d=8, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(b, t, h, d))).astype(np.float32) for _ in range(3)]


def _port(q, k, v, g, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_kv.flash_attention_kv(*leaves)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("split_bwd", ["0", "1"])
def test_plain_matches_the_pallas_kernel(split_bwd, monkeypatch):
    monkeypatch.setenv("W2VHS_FLASHKV_SPLIT_BWD", split_bwd)
    q, k, v = _qkv(1, 300, 2)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    out, grads = _port(q, k, v, g)
    ref, vjp = jax.vjp(lambda *a: jax_flash_kv.flash_attention_kv(*a, 128, 128, True),
                       *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_plain_lse_matches_the_pallas_kernel():
    q, k, v = _qkv(2, 300, 2, seed=2)
    _, (_, _, _, _, lse) = jax_flash_kv._flash_kv_fwd(*map(jnp.asarray, (q, k, v)), 128, 128,
                                                      True, False, False)
    o, got = flash_kv.attention_kv_fwd_reference(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 2, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, :, :300, 0], atol=3e-5)


def test_plain_matches_chunked_attention_across_chunks():
    q, k, v = _qkv(1, 700, 4, seed=3)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    out, grads = _port(q, k, v, g)
    ref, vjp = jax.vjp(_chunked_attention, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_split_passes_are_the_exact_softmax_gradient():
    """The dq and dk/dv passes against autograd of a materialised softmax."""
    q, k, v = _qkv(2, 130, 2, seed=5)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    out, grads = _port(q, k, v, g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in leaves)
    p = torch.softmax(qh @ kh.transpose(-1, -2) / np.sqrt(8.0), dim=-1)
    ref = (p @ vh).permute(0, 2, 1, 3)
    ref.backward(torch.from_numpy(g))
    torch.testing.assert_close(out, ref.detach(), atol=3e-5, rtol=0)
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(got, leaf.grad, atol=3e-5, rtol=0)


def test_bf16_boundary_cast():
    """bfloat16 in: float32 inside, bfloat16 out and bfloat16 gradients."""
    q, k, v = _qkv(1, 260, 2, seed=7)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    out, grads = _port(q, k, v, g, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jax_flash_kv.flash_attention_kv(qb, kb, vb, 128, 128, True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)
    ref_f32, vjp = jax.vjp(lambda *a: jax_flash_kv.flash_attention_kv(*a, 128, 128, True),
                           *(x.astype(jnp.float32) for x in (qb, kb, vb)))
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=2e-2)


def test_large_scores_stay_finite():
    q, k, _ = _qkv(1, 260, 2, seed=9, scale=30.0)       # scores ~ +-1900
    v = _qkv(1, 260, 2, seed=10)[0]
    out, _ = flash_kv.attention_kv_fwd_reference(*map(torch.from_numpy, (q, k, v)))
    ref = _chunked_attention(*map(jnp.asarray, (q, k, v)))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


def test_mask_bias_dropout_and_cpu_kernel_calls_raise():
    q = torch.zeros(1, 16, 2, 8)
    for kw in ({"mask": torch.ones(1)}, {"bias": torch.ones(1)}, {"dropout_rate": 0.1}):
        with pytest.raises(NotImplementedError, match="mask/bias/dropout"):
            flash_kv.flash_attention_kv(q, q, q, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kv.flash_kv_fwd_kernel(q, q, q)
