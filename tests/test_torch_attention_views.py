"""The packed attention route passes views, not copies.

The encoder hands the packed attention (K3b) the head view of its ``[B, T, 3H, d]``
projection, with no copy; the kernel wrappers allocate K3b's output as the head view of a
``[B, T, H, d]`` tensor (so the out-projection's reshape is free) and ``dqkv`` in the
strides of ``qkv``, and hand the kernels views of those tensors. The wrappers' launches
are replaced here by the plain version writing into the buffers they were given, since
the CUDA kernels run only on a card (``chip_smoke.py`` holds them to each other on both
layouts there). On the strided view the packed attention gives the forward and gradients
of the contiguous tensor, and both are held to the JAX ``flash_attention_qkv`` (Pallas in
interpret mode) at rate 0 and to the JAX composition with the port's Philox mask injected at
rate 0.1, at ``tests/test_torch_attention_bwd.py``'s tolerances (f32: 1e-5 forward, 1e-4
gradients).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from wav2vec_heart_sounds_tpu.ops.pallas.attention import flash_attention_qkv as jax_attention
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (
    SelfAttention, Wav2Vec2Config, init_parameters)
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention as port

RATE = 0.1
GEOMETRIES = [(2, 3, 57, 16, None), (2, 3, 57, 16, 40), (1, 12, 40, 64, 33)]


def _projection(b, t, h, d, seed):
    """A ``[B, T, 3H, d]`` projection as numpy, the layout ``F.linear`` leaves."""
    return np.random.default_rng(seed).normal(size=(b, t, 3 * h, d)).astype(np.float32)


def _jax_composition(keep, keys, rate):
    def f(qkv):
        h = qkv.shape[1] // 3
        q, k, v = qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]
        scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
        t = qkv.shape[2] if keys is None else keys
        scores = jnp.where(jnp.arange(qkv.shape[2]) < t, scores, -jnp.inf)
        probs = jnp.where(keep, jax.nn.softmax(scores, axis=-1) / (1.0 - rate), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", probs, v)
    return f


def _train(packed_of, proj, g, keys, rate):
    """``attention_qkv_train`` on ``packed_of(leaf)``; returns the output and the gradient
    of the ``[B, T, 3H, d]`` leaf as ``[B, 3H, T, d]``."""
    leaf = torch.from_numpy(proj).requires_grad_()
    out = port.attention_qkv_train(packed_of(leaf), keys, rate, 2024, 14)
    out.backward(torch.from_numpy(g))
    return out.detach(), leaf.grad.transpose(1, 2)


@pytest.mark.parametrize("b,h,t,d,keys", GEOMETRIES)
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_strided_view_matches_contiguous_and_jax(b, h, t, d, keys, rate):
    proj = _projection(b, t, h, d, seed=t + d)
    g = np.random.default_rng(1).normal(size=(b, h, t, d)).astype(np.float32)
    out_v, grad_v = _train(lambda x: x.transpose(1, 2), proj, g, keys, rate)
    out_c, grad_c = _train(lambda x: x.transpose(1, 2).contiguous(), proj, g, keys, rate)
    torch.testing.assert_close(out_v, out_c, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(grad_v, grad_c, atol=1e-6, rtol=1e-6)

    packed = jnp.asarray(proj.transpose(0, 2, 1, 3))
    if rate == 0.0:
        fn = lambda a: jax_attention(a, jnp.asarray(0, jnp.int32), 0.0, keys, True)  # noqa: E731
    else:
        keep = philox.keep_mask(2024, 14, (b, h, t, t), rate).numpy()
        fn = _jax_composition(keep, keys, rate)
    ref, vjp = jax.vjp(fn, packed)
    ref_grad = np.asarray(vjp(jnp.asarray(g))[0])
    for out, grad in ((out_v, grad_v), (out_c, grad_c)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-4)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("lora_rank", [0, 4])
def test_encoder_passes_the_projection_view(monkeypatch, training, lora_rank):
    """The packed route's attention input shares the storage of the projection's output."""
    cfg = Wav2Vec2Config.tiny(hidden_size=64, num_heads=4, lora_rank=lora_rank)
    module = SelfAttention(cfg, torch.float32)
    init_parameters(module, torch.Generator().manual_seed(1))
    products, seen = [], []
    linear = F.linear

    def spy_linear(x, w, b=None):
        out = linear(x, w, b)
        products.append(out)
        return out

    def spy(name):
        real = getattr(port, name)

        def wrapper(qkv, *args, **kwargs):
            seen.append(qkv)
            return real(qkv, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(F, "linear", spy_linear)
    monkeypatch.setattr(port, "flash_attention_qkv", spy("flash_attention_qkv"))
    monkeypatch.setattr(port, "attention_qkv_train", spy("attention_qkv_train"))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 19, 64)).astype(np.float32))
    if training:
        module(x, seed=99, site=2, rate=RATE).sum().backward()
    else:
        with torch.no_grad():
            module(x)
    (qkv,) = seen
    B, T, H = 3, 19, 4
    assert qkv.shape == (B, 3 * H, T, 16) and not qkv.is_contiguous()
    assert qkv.transpose(1, 2).is_contiguous()              # the head view of [B, T, 3H, d]
    assert qkv._base is not None and qkv._base.numel() == B * T * 3 * 64   # a view
    if lora_rank == 0:                  # with LoRA the view is of the sum with the bypasses
        assert qkv.untyped_storage().data_ptr() == products[0].untyped_storage().data_ptr()


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel wrappers on CPU tensors, their launches done by the plain version into
    the buffers the wrappers allocated; records the views each launch was handed."""
    launched = {}

    def fwd(name, q, k, v, out, lse, t, rate, seed, site):
        launched[name] = (q, k, v, out)
        ref = port.attention_reference(q, k, v, t, rate, seed, site, with_lse=True)
        out.copy_(ref[0])
        if lse is not None:
            lse.copy_(ref[1])

    def bwd(name, q, k, v, out, dout, lse, dq, dk, dv, t, rate, seed, site):
        launched[name] = (q, k, v, dq, dk, dv)
        for buf, ref in zip((dq, dk, dv), port.attention_bwd_reference(
                q, k, v, out, dout, lse, t, rate, seed, site)):
            buf.copy_(ref)

    def check(name, t, *views):
        for x in views:
            assert x.stride(3) == 1 and port._aligned(x), name

    monkeypatch.setattr(port, "_launch_fwd", fwd)
    monkeypatch.setattr(port, "_launch_bwd", bwd)
    monkeypatch.setattr(port, "_check", check)
    return launched


@pytest.mark.parametrize("keys", [None, 13])
def test_packed_wrappers_take_and_give_views(plain_launches, keys):
    B, T, H, d = 2, 17, 3, 64
    proj = torch.from_numpy(_projection(B, T, H, d, seed=3))
    qkv = proj.transpose(1, 2)
    out, lse = port.attention_qkv_fwd(qkv, keys, RATE, 5, 6, with_lse=True)
    q, k, v, out_buf = plain_launches["attention_qkv_fwd"]
    assert q.data_ptr() == qkv.data_ptr() and k.data_ptr() == qkv[:, H:].data_ptr()
    assert out_buf is out and out.transpose(1, 2).is_contiguous()   # [B, T, H, d] underneath
    assert out.transpose(1, 2).reshape(B, T, H * d).data_ptr() == out.data_ptr()
    want = port.attention_qkv_reference(qkv, keys, RATE, 5, 6, with_lse=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])

    dout = torch.randn(B, H, T, d, generator=torch.Generator().manual_seed(4))
    dqkv = port.attention_qkv_bwd(qkv, out, dout, lse, keys, RATE, 5, 6)
    assert dqkv.stride() == qkv.stride()                     # the strides of the qkv view
    dq = plain_launches["attention_qkv_bwd"][3]
    assert dq.data_ptr() == dqkv.data_ptr()
    assert torch.equal(dqkv, port.attention_qkv_bwd_reference(qkv, out, dout, lse, keys, RATE,
                                                              5, 6))


@pytest.mark.parametrize("dtype,width,offset,aligned", [
    (torch.bfloat16, 64, 0, True),       # contiguous rows of 128 bytes
    (torch.bfloat16, 72, 8, True),       # padded rows, base 16 bytes in
    (torch.bfloat16, 72, 1, False),      # base 2 bytes off
    (torch.bfloat16, 66, 0, False),      # 132-byte rows
    (torch.float32, 68, 0, True),        # 272-byte rows
    (torch.float32, 66, 0, False),       # 264-byte rows
])
def test_alignment_of_views(dtype, width, offset, aligned):
    base = torch.zeros(2, 3, 5, width, dtype=dtype)
    view = base[..., offset:offset + 64]
    assert port._aligned(view) is aligned
    dense = port._dense_dout(view)
    assert port._aligned(dense) and dense.stride(3) == 1 and torch.equal(dense, view)
    assert (dense.data_ptr() == view.data_ptr()) is aligned  # copied only when misaligned
