"""Unpacked attention (K3a) and the encoder's unpacked route: plain versions vs JAX.

The plain K3a (:func:`attention_reference` and its backward, through ``attention_train``)
against the Pallas kernel ``flash_attention`` in interpret mode at rate 0, forward and
``jax.vjp`` gradients, f32 (atol 1e-5 forward, 1e-4 gradients), with a key count t < T too.
K3a computes K3b's function and keys its Philox mask at the same element index, so at rate
0.1 the plain K3a route equals the plain K3b route on the packed tensor of the same q, k
and v bit for bit, forward and gradients. The CUDA kernels (one body for both routes) are
held to these plain versions, and to each other bit for bit, by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas.attention import flash_attention as jax_attention
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (
    SelfAttention, Wav2Vec2Config, init_parameters)
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention as port

RATE = 0.1
GEOMETRIES = [(2, 3, 57, 16, None), (2, 3, 57, 16, 40), (1, 12, 40, 64, 33)]


def _heads(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,t,d,keys", GEOMETRIES)
def test_rate0_matches_pallas_interpret(b, h, t, d, keys):
    q, k, v = _heads(b, h, t, d, seed=t + d)
    g = np.random.default_rng(1).normal(size=(b, h, t, d)).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jax_attention(*a, jnp.asarray(0, jnp.int32), 0.0, keys, True),
                       *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port.attention_train(*leaves, keys, 0.0, 0, 0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for got, want in zip(leaves, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-4)
    with torch.no_grad():                           # the eval forward is the same function
        np.testing.assert_allclose(port.flash_attention(*leaves, keys).numpy(), np.asarray(ref),
                                   atol=1e-5)


@pytest.mark.parametrize("keys", [None, 40])
def test_unpacked_equals_packed_bit_for_bit(keys):
    q, k, v = _heads(2, 3, 57, 16, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 3, 57, 16)).astype(np.float32))
    packed = torch.from_numpy(np.concatenate([q, k, v], axis=1)).requires_grad_()
    out_p = port.attention_qkv_train(packed, keys, RATE, 2024, 14)
    out_p.backward(g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out_u = port.attention_train(*leaves, keys, RATE, 2024, 14)
    out_u.backward(g)
    assert torch.equal(out_u, out_p)
    assert torch.equal(torch.cat([a.grad for a in leaves], dim=1), packed.grad)
    # and the mask is the K3b mask: dropout changed the output
    assert not torch.equal(out_u, port.attention_reference(*leaves, keys))


def test_views_of_the_projections_give_the_contiguous_result():
    """The encoder hands head views of ``[B, T, H, d]`` projections, not copies."""
    rng = np.random.default_rng(7)
    proj = [torch.from_numpy(rng.normal(size=(2, 13, 3, 8)).astype(np.float32)) for _ in range(3)]
    views = [p.transpose(1, 2) for p in proj]
    assert not views[0].is_contiguous()
    got = port.attention_reference(*views, 11, RATE, 3, 4, with_lse=True)
    want = port.attention_reference(*(v.contiguous() for v in views), 11, RATE, 3, 4,
                                    with_lse=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_self_attention_routes_agree():
    """``qkv_fuse=False`` (three products, K3a) against the packed route (one product, K3b)
    from one state: equal up to the products' summation order, at rate 0 and with dropout."""
    torch.manual_seed(0)
    cfg = Wav2Vec2Config.tiny(hidden_size=64, num_heads=4, lora_rank=4)
    packed = SelfAttention(cfg, torch.float32)
    init_parameters(packed, torch.Generator().manual_seed(1))
    with torch.no_grad():
        packed.q_proj.lora_b.normal_()
        packed.v_proj.lora_b.normal_()
    unpacked = SelfAttention(Wav2Vec2Config.tiny(hidden_size=64, num_heads=4, lora_rank=4,
                                                 qkv_fuse=False), torch.float32)
    unpacked.load_state_dict(packed.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 19, 64)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(unpacked(x), packed(x), atol=1e-5, rtol=1e-5)
    for module in (packed, unpacked):
        module(x, seed=99, site=2, rate=RATE).square().sum().backward()
    torch.testing.assert_close(unpacked(x, 99, 2, RATE), packed(x, 99, 2, RATE), atol=1e-5,
                               rtol=1e-5)
    grads = dict(packed.named_parameters())
    for name, p in unpacked.named_parameters():
        torch.testing.assert_close(p.grad, grads[name].grad, atol=1e-4, rtol=1e-4, msg=name)


def test_unpacked_wrappers_reject_cpu_tensors():
    q = torch.zeros(1, 2, 10, 64)
    lse = torch.zeros(1, 2, 10)
    before = (port.attention_fwd.launches, port.attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_fwd(q, q, q, None, RATE, 1, 2, with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_bwd(q, q, q, q, q, lse)
    assert (port.attention_fwd.launches, port.attention_bwd.launches) == before
