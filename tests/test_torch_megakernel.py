"""FFN sublayer (K4): the port's plain versions vs the JAX package's ``ffn_block``.

At rate 0 against the Pallas kernel in interpret mode: the forward's ``y``, ``s`` and
``pre`` at atol 2e-5 (the JAX test's own bar) and the VJP of all seven inputs at 1e-4 /
1e-3, in float32 (rational erf) and in bfloat16 (tanh GELU; 3e-2 / 2e-2 for values,
6e-2 / 3e-2 for gradients, as ``test_torch_ffn.py``), also with 32-row blocks over 40
rows (a ragged tail). At rates 0.3 / 0.2 with the port's Philox masks injected into the
JAX composition, and by a directional finite difference (rtol 5e-3, as
``tests/test_megakernel.py``). The plain K4 route equals the decomposed K5 + K2 route
bit for bit. The CUDA kernels are held to these plain versions by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from wav2vec_heart_sounds_tpu.ops.pallas import conv as jax_conv
from wav2vec_heart_sounds_tpu.ops.pallas.megakernel import ffn_block as jax_ffn_block
from wav2vec_heart_sounds_tpu.ops.pallas.megakernel import ffn_block_fwd as jax_ffn_block_fwd
from wav2vec_heart_sounds_tpu_torch.models import wav2vec2
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import EncoderLayer, Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as port
from wav2vec_heart_sounds_tpu_torch.ops.kernels.ffn import dense_gelu_dropout
from wav2vec_heart_sounds_tpu_torch.ops.kernels.resid import dropout_add_layernorm

EPS = 1e-5
NAMES = ("x", "w1", "b1", "w2", "b2", "scale", "bias")


def _inputs(n=40, d=64, f=128, seed=0):
    """JAX layout: w1 [d, f], w2 [f, d]."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=f) * 0.01).astype(np.float32),
            (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32),
            (rng.normal(size=d) * 0.01).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.01 * rng.normal(size=d)).astype(np.float32)]


def _cotangent(n, d, seed=9):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _port(args, g, seed, s_act, s_hid, ra, rh, dtype=torch.float32):
    """The port op on the JAX layout; returns (y, grads in the JAX layout)."""
    x, w1, b1, w2, b2, sc, bi = args
    ts = [torch.from_numpy(np.array(a, np.float32)).to(t).requires_grad_()
          for a, t in ((x, dtype), (w1.T, dtype), (b1, dtype), (w2.T, dtype), (b2, dtype),
                       (sc, torch.float32), (bi, torch.float32))]
    y = port.ffn_block(*ts, seed, s_act, s_hid, ra, rh, EPS)
    y.backward(torch.from_numpy(g).to(dtype))
    grads = [t.grad.float().numpy() for t in ts]
    grads[1], grads[3] = grads[1].T, grads[3].T
    return y.detach().float().numpy(), grads


def _jax_args(args, dtype=jnp.float32):
    return [jnp.asarray(a, dtype if i < 5 else jnp.float32) for i, a in enumerate(args)]


@pytest.mark.parametrize("n,rows", [(64, "128"), (40, "32")])
def test_rate0_f32_forward_matches_pallas_interpret(monkeypatch, n, rows):
    monkeypatch.setenv("W2VHS_MEGA_ROWS", rows)            # 32: a 2-block grid, 24 tail rows
    args = _inputs(n=n)
    y, s, pre = jax_ffn_block_fwd(*_jax_args(args), jnp.asarray(0, jnp.int32), 0.0, 0.0, EPS,
                                  True)
    x, w1, b1, w2, b2, sc, bi = (torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (args[0], args[1].T, args[2], args[3].T, *args[4:]))
    got = port.ffn_mega_fwd_reference(x, w1, b1, w2, b2, sc, bi, 1, 2, 3, 0.0, 0.0, EPS)
    for a, b in zip(got, (y, s, pre)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("n,rows", [(64, "128"), (40, "32")])
def test_rate0_f32_vjp_matches_pallas_interpret(monkeypatch, n, rows):
    monkeypatch.setenv("W2VHS_MEGA_ROWS", rows)
    args, g = _inputs(n=n, seed=1), _cotangent(n, 64)
    seed = jnp.asarray(0, jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_ffn_block(*a, seed, 0.0, 0.0, EPS, True), *_jax_args(args))
    y, grads = _port(args, g, 5, 6, 7, 0.0, 0.0)
    np.testing.assert_allclose(y, np.asarray(ref), atol=2e-5)
    for name, got, want in zip(NAMES, grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3, err_msg=name)


def test_rate0_bf16_matches_the_tanh_path():
    """bf16: the Pallas kernel in interpret mode takes the tanh GELU, as the port does."""
    args, g = _inputs(n=64, seed=2), _cotangent(64, 64)
    jargs = _jax_args(args, jnp.bfloat16)
    gb = jnp.asarray(g, jnp.bfloat16)
    seed = jnp.asarray(0, jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_ffn_block(*a, seed, 0.0, 0.0, EPS, True), *jargs)
    rounded = [np.asarray(a, np.float32) for a in jargs]
    y, grads = _port(rounded, np.asarray(gb, np.float32), 5, 6, 7, 0.0, 0.0, torch.bfloat16)
    # one bf16 ulp at unit scale is 7.8e-3; products and bias adds round at other points
    np.testing.assert_allclose(y, np.asarray(ref, np.float32), atol=3e-2, rtol=2e-2)
    for name, got, want in zip(NAMES, grads, vjp(gb)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=6e-2, rtol=3e-2,
                                   err_msg=name)


def _jax_composition(keep_a, keep_h, ra, rh):
    def f(x, w1, b1, w2, b2, sc, bi):
        h = jnp.where(keep_a, jax_conv._gelu_exact(x @ w1 + b1) / (1.0 - ra), 0.0)
        s = x + jnp.where(keep_h, (h @ w2 + b2) / (1.0 - rh), 0.0)
        mean = jnp.mean(s, axis=-1, keepdims=True)
        var = jnp.maximum(jnp.mean(s * s, axis=-1, keepdims=True) - mean * mean, 0.0)
        return (s - mean) * jax.lax.rsqrt(var + EPS) * sc + bi

    return f


@pytest.mark.parametrize("n", [40, 64])
def test_injected_masks_match_jax_composition(n):
    args, g = _inputs(n=n, seed=3), _cotangent(n, 64)
    ra, rh, seed, s_act, s_hid = 0.3, 0.2, 77, 10, 11
    keep_a = philox.keep_mask(seed, s_act, (n, 128), ra).numpy()
    keep_h = philox.keep_mask(seed, s_hid, (n, 64), rh).numpy()
    assert 0 < keep_a.mean() < 1 and 0 < keep_h.mean() < 1
    ref, vjp = jax.vjp(_jax_composition(keep_a, keep_h, ra, rh), *_jax_args(args))
    y, grads = _port(args, g, seed, s_act, s_hid, ra, rh)
    np.testing.assert_allclose(y, np.asarray(ref), atol=2e-5)
    for name, got, want in zip(NAMES, grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3, err_msg=name)


def test_finite_difference_with_dropout_masks():
    """The backward regenerates both forward masks: a directional finite difference at
    rates 0.3 / 0.2 agrees with the analytic gradient (mirrors ``tests/test_megakernel.py``)."""
    args = _inputs(n=48, seed=4)
    x, w1, b1, w2, b2, sc, bi = (torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (args[0], args[1].T, args[2], args[3].T, *args[4:]))

    def loss(v):
        return (port.ffn_block(v, w1, b1, w2, b2, sc, bi, 7, 1, 2, 0.3, 0.2, EPS) ** 2).sum()

    xg = x.clone().requires_grad_()
    loss(xg).backward()
    v = torch.from_numpy(np.random.default_rng(5).normal(size=x.shape).astype(np.float32))
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(x + eps * v) - loss(x - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(fd), float((xg.grad * v).sum()), rtol=5e-3)


def _layer_run(cfg, dtype, x, mega):
    layer = EncoderLayer(dataclasses.replace(cfg, ffn_mega=mega), dtype, index=1)
    wav2vec2.init_parameters(layer, torch.Generator().manual_seed(1))
    xx = x.clone().requires_grad_()
    y = layer(xx, seed=123)
    y.float().pow(2).sum().backward()
    return y.detach(), xx.grad, {n: p.grad for n, p in layer.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_route_equals_the_decomposed_route(monkeypatch, dtype):
    """On the CPU the K4 route is the K5 + output_dense + K2 route bit for bit: the same
    masks, the same ops, the same rounding points, forward and every gradient."""
    cfg = Wav2Vec2Config.tiny(hidden_size=32, intermediate_size=64, hidden_dropout=0.2,
                              activation_dropout=0.3, attention_dropout=0.1)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 17, 32)).astype(np.float32))
    calls = []
    real = wav2vec2.ffn_block
    monkeypatch.setattr(wav2vec2, "ffn_block", lambda *a: calls.append(1) or real(*a))
    mega = _layer_run(cfg, dtype, x.to(dtype), True)
    assert calls == [1]                                       # ffn_mega defaults to K4 ...
    assert Wav2Vec2Config().ffn_mega
    split = _layer_run(cfg, dtype, x.to(dtype), False)
    assert calls == [1]                                       # ... and False is the K5 route
    assert torch.equal(mega[0], split[0]) and torch.equal(mega[1], split[1])
    for name, grad in mega[2].items():
        assert torch.equal(grad, split[2][name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_equal_the_decomposed_ops(dtype):
    """The op itself (no layer around it) against the three decomposed ops."""
    args = _inputs(n=30, d=32, f=64, seed=7)
    x, w1, b1, w2, b2, sc, bi = (torch.from_numpy(np.ascontiguousarray(a)).to(
        dtype if i < 5 else torch.float32)
        for i, a in enumerate((args[0], args[1].T, args[2], args[3].T, *args[4:])))
    g = torch.from_numpy(_cotangent(30, 32)).to(dtype)
    results = []
    for mega in (True, False):
        ts = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2, sc, bi)]
        if mega:
            y = port.ffn_block(*ts, 9, 4, 5, 0.3, 0.2, EPS)
        else:
            h = F.linear(dense_gelu_dropout(ts[0], ts[1], ts[2], 9, 4, 0.3), ts[3], ts[4])
            y = dropout_add_layernorm(h, ts[0], ts[5], ts[6], 9, 5, 0.2, EPS)
        y.backward(g)
        results.append([y.detach()] + [t.grad for t in ts])
    for name, a, b in zip(("y",) + NAMES, *results):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_kernel_wrappers_reject_cpu_tensors():
    args = _inputs(n=8, d=768, f=128)
    x, w1, b1, w2, b2, sc, bi = (torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (args[0], args[1].T, args[2], args[3].T, *args[4:]))
    before = (port.ffn_mega_fwd_kernel.launches, port.ffn_mega_bwd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port.ffn_mega_fwd_kernel(x, w1, b1, w2, b2, sc, bi, 0, 1, 2, 0.1, 0.1, EPS)
    pre = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        port.ffn_mega_bwd_kernel(x, x, pre, w2, sc, 0, 1, 2, 0.1, 0.1, EPS)
    assert (port.ffn_mega_fwd_kernel.launches, port.ffn_mega_bwd_kernel.launches) == before
