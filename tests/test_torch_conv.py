"""K8, the fused ``gelu(conv)`` of the feature encoder's ``conv_fuse`` route: plain versions
vs JAX, and the layer gate.

The plain K8 (:mod:`wav2vec_heart_sounds_tpu_torch.ops.kernels.conv`, ``[B, C, T]`` layout,
exact lengths) against the Pallas kernel ``conv_gelu`` in interpret mode and against
``reference_conv_gelu`` at the shapes of ``tests/test_pallas_conv.py`` and that file's bars
(forward atol 2e-5 / rtol 1e-5; gradients of ``sum(sin(.))`` atol 5e-4 / rtol 1e-4); the
Pallas kernel needs ``conv_time_plan``'s padded input, so it is compared on the frames it
computes. Odd output lengths, which only the port runs (no padding: the last frame's tap 2
reads the last input row, and that row's gradient is the tap-2 term alone), against
``reference_conv_gelu`` and its ``jax.vjp``. The port's gate
(:func:`conv_fuse_layers`) picks exactly the layers the JAX package's ``fused`` list picks.
The CUDA kernels are held to the plain versions by ``chip_smoke.py`` on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models import wav2vec2 as jax_w2v
from wav2vec_heart_sounds_tpu.ops.pallas.conv import conv_gelu as jax_conv_gelu
from wav2vec_heart_sounds_tpu.ops.pallas.conv import reference_conv_gelu
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config, conv_fuse_layers
from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv as port


def _case(b=2, t=264, cin=128, cout=128, seed=0):
    """JAX layout: x [B, T, C], w [3, C, Co] (as ``tests/test_pallas_conv.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, cin)).astype(np.float32)
    w = (rng.normal(size=(3, cin, cout)) * 0.05).astype(np.float32)
    return x, w


def _port(x, w, frames=None):
    """Forward and the gradients of ``sum(sin(out[:, :, :frames]))`` through the port."""
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    wt = torch.from_numpy(w.transpose(2, 1, 0).copy()).requires_grad_()
    out = port.conv_gelu(xt, wt)[:, :, :frames]
    out.sin().sum().backward()
    return (out.detach().numpy().transpose(0, 2, 1), xt.grad.numpy().transpose(0, 2, 1),
            wt.grad.numpy().transpose(2, 1, 0))


@pytest.mark.parametrize("b,t,out_len,seed", [(2, 264, 128, 0), (3, 2 * 256 + 8, 256, 1)])
def test_matches_pallas_interpret_and_reference(b, t, out_len, seed):
    x, w = _case(b=b, t=t, seed=seed)
    out, dx, dw = _port(x, w, out_len)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    kernel = jax_conv_gelu(xj, wj, out_len, True)
    np.testing.assert_allclose(out, np.asarray(kernel), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(reference_conv_gelu(xj, wj, out_len)),
                               atol=2e-5, rtol=1e-5)
    grads = jax.grad(lambda a, c: jnp.sum(jnp.sin(jax_conv_gelu(a, c, out_len, True))),
                     argnums=(0, 1))(xj, wj)
    for got, want in zip((dx, dw), grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("t", [263, 264, 301])
def test_odd_lengths_match_reference(t):
    x, w = _case(b=2, t=t, cout=256, seed=t)
    out_len = (t - 3) // 2 + 1
    out, dx, dw = _port(x, w)
    assert out.shape == (2, out_len, 256)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    ref, vjp = jax.vjp(lambda a, c: reference_conv_gelu(a, c, out_len), xj, wj)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-5)
    want_dx, want_dw = vjp(jnp.cos(ref))
    np.testing.assert_allclose(dx, np.asarray(want_dx), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(want_dw), atol=5e-4, rtol=1e-4)
    assert np.abs(dx[:, 2 * out_len]).max() > 0            # the tap-2 tail row
    if t > 2 * out_len + 1:
        assert not dx[:, 2 * out_len + 1:].any()             # rows no frame reads


def test_bf16_rounds_pre_and_takes_the_gradient_there():
    x, w = _case(b=1, t=101, seed=4)
    xb = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(torch.bfloat16)
    wb = torch.from_numpy(w.transpose(2, 1, 0).copy()).to(torch.bfloat16)
    out, pre = port.conv_gelu_fwd_reference(xb, wb)
    assert out.dtype == pre.dtype == torch.bfloat16
    y = torch.nn.functional.conv1d(xb.float(), wb.float(), stride=2)    # exact bf16 products
    torch.testing.assert_close(pre, y.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(out.float(), torch.nn.functional.gelu(y), atol=1e-2, rtol=1e-2)
    g = torch.ones_like(out)
    dx, dw = port.conv_gelu_bwd_reference(xb, wb, pre, g)
    assert dx.dtype == dw.dtype == torch.bfloat16 and dx.shape == xb.shape
    dpre = (port.gelu.gelu_erf_grad(pre)).to(torch.bfloat16).float()
    want = torch.nn.grad.conv1d_weight(xb.float(), wb.shape, dpre, stride=2)
    torch.testing.assert_close(dw, want.to(torch.bfloat16), rtol=0, atol=0)


def _jax_fused(cfg, n, monkeypatch):
    """The ``fused`` list the JAX feature encoder hands ``conv_time_plan`` for an ``n``-sample
    input with ``W2VHS_CONVFUSE=1`` (traced, not run)."""
    monkeypatch.setenv("W2VHS_CONVFUSE", "1")
    seen, plan = [], jax_w2v.conv_time_plan

    def spy(*args, fused=None):
        seen.append(list(fused))
        return plan(*args, fused=fused)

    monkeypatch.setattr(jax_w2v, "conv_time_plan", spy)
    encoder = jax_w2v.FeatureEncoder(cfg)
    jax.eval_shape(encoder.init, jax.random.key(0), jnp.zeros((1, n)))
    return seen[0]


@pytest.mark.parametrize("n,expected", [(64000, [1]), (16500, []), (8194, [1])])
def test_gate_picks_the_jax_layers(n, expected, monkeypatch):
    """wav2vec2-base: conv_1 alone at 4 s of 16 kHz; none at the fusion path's 4 s of
    4125 Hz; the tiny gated config of ``tests/test_torch_gated_route.py`` at 8194."""
    if n == 8194:
        kw = dict(conv_dim=(128, 128, 32, 32), conv_kernel=(2, 3, 3, 3),
                  conv_stride=(1, 2, 2, 2))
        ours = Wav2Vec2Config.tiny(conv_fuse=True, **kw)
        jax_cfg = jax_w2v.Wav2Vec2Config.tiny(**kw)
    else:
        ours, jax_cfg = Wav2Vec2Config(conv_fuse=True), jax_w2v.Wav2Vec2Config()
    fused = conv_fuse_layers(ours, n)
    assert fused == _jax_fused(jax_cfg, n, monkeypatch)
    assert [i for i, f in enumerate(fused) if f] == expected
    assert not any(conv_fuse_layers(Wav2Vec2Config(), n))              # conv_fuse off


def test_kernel_wrappers_reject_cpu_tensors():
    x, w = torch.zeros(1, 128, 11), torch.zeros(128, 128, 3)
    before = (port.conv_gelu_fwd_kernel.launches, port.conv_gelu_bwd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port.conv_gelu_fwd_kernel(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        port.conv_gelu_bwd_kernel(x, w, torch.zeros(1, 128, 5), torch.zeros(1, 128, 5))
    assert (port.conv_gelu_fwd_kernel.launches, port.conv_gelu_bwd_kernel.launches) == before
