"""Training attention (K3b forward with dropout, and its backward): plain versions vs JAX.

At rate 0 against the Pallas kernel ``flash_attention_qkv`` in interpret mode, forward and
VJP (f32 atol 1e-5 on the output, 1e-4 on the packed dqkv). At rate 0.1 with the port's
Philox mask injected into the JAX einsum composition (softmax, ``where(keep, p / (1 - r),
0)``, PV), values and ``jax.vjp`` gradients: the backward, which recomputes the
probabilities from the saved log-sum-exp and regenerates the mask, must give the gradient
of the very function the forward computed. The CUDA kernels are held to these plain
versions by ``chip_smoke.py`` on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas.attention import flash_attention_qkv as jax_attention
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention as port

RATE = 0.1
GEOMETRIES = [(2, 3, 57, 16, None), (2, 3, 57, 16, 40), (1, 12, 40, 64, 33)]


def _qkv(b, h, t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 3 * h, t, d)).astype(np.float32)


def _port(x, g, keys, rate, seed=0, site=0):
    xt = torch.from_numpy(x).requires_grad_()
    out = port.attention_qkv_train(xt, keys, rate, seed, site)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("b,h,t,d,keys", GEOMETRIES)
def test_rate0_matches_pallas_interpret(b, h, t, d, keys):
    x = _qkv(b, h, t, d, seed=t + d)
    g = np.random.default_rng(1).normal(size=(b, h, t, d)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_attention(a, jnp.asarray(0, jnp.int32), 0.0, keys, True),
                       jnp.asarray(x))
    out, dqkv = _port(x, g, keys, 0.0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(dqkv, np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-4)


def _jax_composition(keep, keys, rate):
    def f(qkv):
        h = qkv.shape[1] // 3
        q, k, v = qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]
        scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
        t = qkv.shape[2] if keys is None else keys
        scores = jnp.where(jnp.arange(qkv.shape[2]) < t, scores, -jnp.inf)
        probs = jax.nn.softmax(scores, axis=-1)
        probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", probs, v)
    return f


@pytest.mark.parametrize("b,h,t,d,keys", GEOMETRIES)
def test_injected_mask_matches_jax_composition(b, h, t, d, keys):
    x = _qkv(b, h, t, d, seed=3)
    g = np.random.default_rng(4).normal(size=(b, h, t, d)).astype(np.float32)
    keep = philox.keep_mask(2024, 14, (b, h, t, t), RATE).numpy()
    ref, vjp = jax.vjp(_jax_composition(keep, keys, RATE), jnp.asarray(x))
    out, dqkv = _port(x, g, keys, RATE, seed=2024, site=14)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(dqkv, np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-4)


def test_forward_saves_the_log_sum_exp():
    x = torch.from_numpy(_qkv(2, 2, 23, 8, seed=5))
    out, lse = port.attention_qkv_reference(x, 17, RATE, 1, 2, with_lse=True)
    q, k = x[:, :2], x[:, 2:4]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k)[..., :17] / np.sqrt(8)
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1))
    torch.testing.assert_close(out, port.attention_qkv_reference(x, 17, RATE, 1, 2))


def test_backward_takes_a_strided_cotangent():
    """The model hands ``out.transpose(1, 2).reshape(...)``'s gradient back as a strided view."""
    x = torch.from_numpy(_qkv(2, 2, 11, 8, seed=6)).requires_grad_()
    out = port.attention_qkv_train(x, None, RATE, 5, 3)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 11, 2, 8)).astype(np.float32))
    out.backward(g.transpose(1, 2))                      # a non-contiguous [B, H, T, d] view
    ref = x.detach().clone().requires_grad_()
    port.attention_qkv_reference(ref, None, RATE, 5, 3).backward(g.transpose(1, 2))
    torch.testing.assert_close(x.grad, ref.grad, atol=1e-5, rtol=1e-5)


def test_bf16_backward_tracks_f32():
    x = _qkv(1, 2, 30, 16, seed=8)
    g = np.random.default_rng(9).normal(size=(1, 2, 30, 16)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, lse = port.attention_qkv_reference(xb, None, RATE, 3, 4, with_lse=True)
    dqkv = port.attention_qkv_bwd_reference(xb, out, torch.from_numpy(g).to(torch.bfloat16),
                                            lse, None, RATE, 3, 4)
    assert out.dtype == dqkv.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _, ref = _port(xb.float().numpy(), g, None, RATE, seed=3, site=4)
    # bf16 inputs and outputs (1 ulp = 2^-8 relative) around float32 math
    np.testing.assert_allclose(dqkv.float().numpy(), ref, atol=5e-2, rtol=5e-2)


def test_backward_wrapper_rejects_cpu_tensors():
    x = torch.from_numpy(_qkv(1, 2, 10, 64))
    o = torch.zeros(1, 2, 10, 64)
    lse = torch.zeros(1, 2, 10)
    before = port.attention_qkv_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_qkv_bwd(x, o, o, lse)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_qkv_fwd(x, None, RATE, 1, 2, with_lse=True)
    assert port.attention_qkv_bwd.launches == before
