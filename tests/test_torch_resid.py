"""Residual tail ``LayerNorm(x + dropout(h))`` (K2): the port's plain versions vs the JAX package.

At rate 0 against the Pallas kernel in interpret mode (forward and VJP, f32 atol 1e-5);
at rate 0.1 with the port's Philox mask injected into the JAX composition
(``reference_dropout_add_layernorm``'s formula with ``where(keep, ...)``), values and
``jax.vjp`` gradients. The CUDA kernels are held to these plain versions by
``chip_smoke.py`` on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas.resid import dropout_add_layernorm as jax_resid
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import resid as port

EPS, RATE = 1e-5, 0.1


def _inputs(shape=(37, 64), seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.1, size=c).astype(np.float32),
            rng.normal(0.0, 0.1, size=c).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _port(h, x, w, b, g, seed, site, rate):
    ts = [torch.from_numpy(a).requires_grad_() for a in (h, x, w, b)]
    out = port.dropout_add_layernorm(*ts, seed, site, rate, EPS)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _compare(out, grads, ref, ref_grads, atol):
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("shape", [(37, 64), (2, 9, 32)])
def test_rate0_matches_pallas_interpret(shape):
    h, x, w, b, g = _inputs(shape)
    seed = jnp.asarray(0, jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_resid(*a, seed, 0.0, EPS, True),
                       *map(jnp.asarray, (h, x, w, b)))
    out, grads = _port(h, x, w, b, g, 3, 7, 0.0)
    _compare(out, grads, ref, vjp(jnp.asarray(g)), 1e-5)


def _jax_composition(keep, rate):
    def f(h, x, w, b):
        hf = jnp.where(keep, h / (1.0 - rate), 0.0)
        sf = x + hf
        mean = jnp.mean(sf, axis=-1, keepdims=True)
        var = jnp.maximum(jnp.mean(jnp.square(sf), axis=-1, keepdims=True)
                          - jnp.square(mean), 0.0)
        return (sf - mean) * jax.lax.rsqrt(var + EPS) * w + b
    return f


@pytest.mark.parametrize("shape", [(37, 64), (2, 9, 32)])
def test_injected_mask_matches_jax_composition(shape):
    h, x, w, b, g = _inputs(shape, seed=2)
    keep = philox.keep_mask(99, 12, shape, RATE).numpy()
    ref, vjp = jax.vjp(_jax_composition(keep, RATE), *map(jnp.asarray, (h, x, w, b)))
    out, grads = _port(h, x, w, b, g, 99, 12, RATE)
    _compare(out, grads, ref, vjp(jnp.asarray(g)), 2e-5)


def test_forward_and_backward_share_the_mask():
    h, x, w, b, g = _inputs(seed=3)
    keep = philox.keep_mask(5, 6, h.shape, RATE)
    out, s = port.resid_fwd_reference(*map(torch.from_numpy, (h, x, w, b)), 5, 6, RATE, EPS)
    # s - x is the dropped h: zero exactly where the mask drops
    dropped = s - torch.from_numpy(x)
    assert bool((dropped[~keep] == 0).all()) and bool((dropped[keep] != 0).all())
    dh, dx, _, _ = port.resid_bwd_reference(torch.from_numpy(g), s, torch.from_numpy(w), 5, 6,
                                            RATE, EPS)
    assert bool((dh[~keep] == 0).all())
    torch.testing.assert_close(dh[keep], dx[keep] * philox.keep_scale(RATE))


def test_bf16_sum_is_rounded_before_the_statistics():
    h, x, w, b, _ = _inputs(seed=4)
    hb, xb = (torch.from_numpy(a).to(torch.bfloat16) for a in (h, x))
    out, s = port.resid_fwd_reference(hb, xb, torch.from_numpy(w), torch.from_numpy(b), 1, 2,
                                      0.0, EPS)
    assert out.dtype == s.dtype == torch.bfloat16
    torch.testing.assert_close(s, (hb.float() + xb.float()).to(torch.bfloat16), rtol=0, atol=0)
    sf = s.float()
    mean = sf.mean(-1, keepdim=True)
    var = (sf * sf).mean(-1, keepdim=True) - mean * mean
    expected = ((sf - mean) * torch.rsqrt(var + EPS) * torch.from_numpy(w)
                + torch.from_numpy(b)).to(torch.bfloat16)
    torch.testing.assert_close(out, expected, rtol=0, atol=0)


def test_kernel_wrappers_reject_cpu_tensors():
    h = torch.zeros(4, 128)
    w = torch.ones(128)
    before = (port.resid_fwd_kernel.launches, port.resid_bwd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port.resid_fwd_kernel(h, h, w, w, 0, 0, RATE, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        port.resid_bwd_kernel(h, h, w, 0, 0, RATE, EPS)
    assert (port.resid_fwd_kernel.launches, port.resid_bwd_kernel.launches) == before
