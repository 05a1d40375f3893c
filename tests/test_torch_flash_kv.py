"""K6, the delay predictor's attention: the port's plain versions vs the JAX package.

``flash_attention_kv`` on CPU tensors runs the plain forward and the plain fused backward
(the formulas of ``csrc/flash_kv.cu``: query-chunked, the backward key-blocked with dq from
partials summed in key-block order). They are held to the Pallas kernel
in interpret mode (forward, lse and ``jax.vjp``, with the default fused backward and under
``W2VHS_FLASHKV_SPLIT_BWD=1``, at T = 300 with 128-row blocks, so the padding and the
``col < t`` mask are exercised) and to ``_chunked_attention`` (T = 700: two query chunks).
Bars as ``tests/test_pallas_flash_kv.py``: atol 3e-5 in float32 (sums in other orders),
2e-2 across the bfloat16 boundary cast (one bf16 ulp at unit scale is 7.8e-3). The
key-blocked backward is also held to JAX's fused pass at T = 700 with 256-key blocks (a
ragged last block). A model of the kernel's operand precision (3xTF32: every product as
``hi hi + hi lo + lo hi`` of TF32 halves, hi truncated) is held to the card's bars against the float32
plain version at T = 2048, and one TF32 product is shown to miss them.
"""

import math

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
    """The fused backward (key blocks, dq partials) against autograd of a materialised
    softmax."""
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


@pytest.mark.parametrize("key_block", [256, 512])
def test_key_blocked_backward_matches_the_fused_pallas_pass(key_block, monkeypatch):
    """T = 700: three 256-key blocks (or two of 512), the last ragged, against JAX's fused
    ``_bwd_fused_kernel`` at 256-row blocks in interpret mode."""
    monkeypatch.setenv("W2VHS_FLASHKV_SPLIT_BWD", "0")
    q, k, v = _qkv(1, 700, 2, seed=11)
    g = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = flash_kv.attention_kv_fwd_reference(tq, tk, tv)
    got = flash_kv.attention_kv_bwd_reference(tq, tk, tv, o, lse, tg, key_block=key_block)
    _, vjp = jax.vjp(lambda *a: jax_flash_kv.flash_attention_kv(*a, 256, 256, True),
                     *map(jnp.asarray, (q, k, v)))
    for a, want in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=3e-5)


def _tf32(x: torch.Tensor, round_: bool = False) -> torch.Tensor:
    """float32 -> TF32 (10-bit mantissa): truncated, as the kernel splits its operands and
    as the tensor cores read an unrounded one, or with ``round_`` to nearest, ties away from
    zero (``cvt.rna``)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if round_:
        bits = bits + 0x1000                   # sign-magnitude: ties round away from zero
    return (bits & 0xFFFFE000).to(torch.uint32).view(torch.int32).view(torch.float32)


def _mm(a, b, passes):
    """``a @ b`` as the kernel forms it on the tensor cores: 3 passes is 3xTF32 (hi = x
    truncated to TF32, lo = x - hi; ``lo hi + hi lo``, then ``hi hi``, float32 sums), 1 pass
    a single TF32 product of the operands rounded to nearest."""
    if passes == 1:
        return _tf32(a, round_=True) @ _tf32(b, round_=True)
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def _modelled_attention(q, k, v, g, passes):
    """The kernel's forward and backward formulas on ``[B, H, T, 8]`` with each product
    through :func:`_mm`: scores in log2 units (log2(e) / sqrt(8) folded into q), one ex2 a
    score, dq and dk scaled at the end."""
    scale = 1.0 / math.sqrt(8.0)
    qs = q * torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    s = _mm(qs, k.transpose(-1, -2), passes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = _mm(p, v, passes) / l
    lse = (m + torch.log2(l))[..., 0] * math.log(2.0)
    p = torch.exp2(s - (lse * math.log2(math.e))[..., None])
    delta = (g * o).sum(dim=-1, keepdim=True)
    dv = _mm(p.transpose(-1, -2), g, passes)
    ds = p * (_mm(g, v.transpose(-1, -2), passes) - delta)
    dk = _mm(ds.transpose(-1, -2), q, passes) * scale
    dq = _mm(ds, k, passes) * scale
    return o, lse, dq, dk, dv


def _worst(got, want, atol, rtol):
    """The largest ``|got - want| / (atol + rtol |want|)``: at most 1 inside the bar."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def test_tf32x3_operands_hold_the_float32_bars():
    """The card's bars (o and lse 2e-5 / 1e-4, gradients 1e-4 / 1e-3) against the float32
    plain version at T = 2048, unit-normal q, k, v, g: 3xTF32 inside them, one TF32 product
    (~11 bits) outside."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2048, 2, seed=13))
    g = torch.from_numpy(np.random.default_rng(14).normal(size=q.shape).astype(np.float32))
    o, lse = flash_kv.attention_kv_fwd_reference(q, k, v)
    want = (o, lse, *flash_kv.attention_kv_bwd_reference(q, k, v, o, lse, g))
    bars = ((2e-5, 1e-4),) * 2 + ((1e-4, 1e-3),) * 3
    heads = [x.permute(0, 2, 1, 3) for x in (q, k, v, g)]
    worst = {}
    for passes in (3, 1):
        got = list(_modelled_attention(*heads, passes))
        got = [got[0].permute(0, 2, 1, 3), got[1]] + [x.permute(0, 2, 1, 3) for x in got[2:]]
        worst[passes] = [_worst(a, w, *bar) for a, w, bar in zip(got, want, bars)]
    assert max(worst[3]) <= 1.0, worst
    assert worst[1][0] > 1.0, worst
