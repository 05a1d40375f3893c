"""FFN activation ``dropout(gelu(x W + b))`` (K5): the port's plain versions vs the JAX package.

At rate 0 against the Pallas kernel in interpret mode, forward and VJP (dx, dW, db): in
float32 with the rational erf (atol 1e-5), and in bfloat16 with the tanh form (the JAX
kernel's bf16 default). At rate 0.1 with the port's Philox mask injected into the JAX
composition ``where(keep, gelu(x W + b) / (1 - r), 0)``. The CUDA kernels are held to
these plain versions by ``chip_smoke.py`` on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas import conv as jax_conv
from wav2vec_heart_sounds_tpu.ops.pallas.ffn import dense_gelu_dropout as jax_ffn
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout
from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn as port

RATE = 0.1


def _inputs(n=29, cin=24, cout=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, cin)).astype(np.float32),
            (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32),
            rng.normal(0.0, 0.1, size=cout).astype(np.float32),
            rng.normal(size=(n, cout)).astype(np.float32))


def _port(x, w, b, g, seed, site, rate, dtype=torch.float32):
    """Port op on the JAX layout (w [in, out]); returns output and (dx, dw [in, out], db)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).to(dtype).requires_grad_()
    bt = torch.from_numpy(b).to(dtype).requires_grad_()
    out = port.dense_gelu_dropout(xt, wt, bt, seed, site, rate)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach().float().numpy(), [xt.grad.float().numpy(),
                                          wt.grad.float().numpy().T, bt.grad.float().numpy()]


def test_rate0_f32_matches_pallas_interpret():
    x, w, b, g = _inputs()
    seed = jnp.asarray(0, jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_ffn(*a, seed, 0.0, True), *map(jnp.asarray, (x, w, b)))
    out, grads = _port(x, w, b, g, 1, 2, 0.0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rate0_bf16_matches_the_tanh_path():
    """bf16: the Pallas kernel in interpret mode takes the tanh GELU (``_tanh_act``)."""
    x, w, b, g = _inputs(seed=1)
    seed = jnp.asarray(0, jnp.int32)
    xb, wb, bb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, g))
    ref, vjp = jax.vjp(lambda *a: jax_ffn(*a, seed, 0.0, True), xb, wb, bb)
    out, grads = _port(*(np.asarray(a, np.float32) for a in (xb, wb, bb, gb)), 1, 2, 0.0,
                       torch.bfloat16)
    # one bf16 ulp at unit scale is 7.8e-3; products and bias adds round at other points
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=3e-2, rtol=2e-2)
    for got, want in zip(grads, vjp(gb)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=6e-2, rtol=3e-2)
    # and the activation itself is the tanh form, not erf
    pre = torch.linspace(-3, 3, 64, dtype=torch.bfloat16)
    act = port.ffn_act_fwd_reference(pre, 0, 0, 0.0).float()
    tanh = jax_conv._gelu_tanh(jnp.asarray(pre.float().numpy()))
    # equal up to one bf16 rounding step (2^-8 relative) of float32 values that differ in ulps
    np.testing.assert_allclose(act.numpy(), np.asarray(jnp.asarray(tanh, jnp.bfloat16),
                                                       np.float32), atol=1e-6, rtol=2 ** -8)


@pytest.mark.parametrize("n", [29, 64])
def test_injected_mask_matches_jax_composition(n):
    x, w, b, g = _inputs(n=n, seed=2)
    keep = philox.keep_mask(77, 9, (n, w.shape[1]), RATE).numpy()

    def f(x, w, b):
        h = jax_conv._gelu_exact(x @ w + b)
        return jnp.where(keep, h / (1.0 - RATE), 0.0)

    ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, b)))
    out, grads = _port(x, w, b, g, 77, 9, RATE)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(out != 0, keep & (np.asarray(ref) != 0))
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)


def test_backward_regenerates_the_forward_mask():
    x, w, b, g = _inputs(seed=3)
    pre = torch.from_numpy(x @ w + b)
    keep = philox.keep_mask(4, 8, pre.shape, RATE)
    y = port.ffn_act_fwd_reference(pre, 4, 8, RATE)
    dpre, dbias = port.ffn_act_bwd_reference(torch.from_numpy(g), pre, 4, 8, RATE)
    assert bool((y[~keep] == 0).all()) and bool((dpre[~keep] == 0).all())
    assert bool((dpre[keep] != 0).all())
    torch.testing.assert_close(dbias, dpre.sum(0))


def test_kernel_wrappers_reject_cpu_tensors():
    pre = torch.zeros(4, 16)
    before = (port.ffn_act_fwd_kernel.launches, port.ffn_act_bwd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port.ffn_act_fwd_kernel(pre, 0, 0, RATE)
    with pytest.raises(ValueError, match="CUDA"):
        port.ffn_act_bwd_kernel(pre, pre, 0, 0, RATE)
    assert (port.ffn_act_fwd_kernel.launches, port.ffn_act_bwd_kernel.launches) == before


def test_the_kernels_take_rows_of_four_column_groups():
    """The backward's threads own four adjacent columns of every row; the forward any length."""
    assert port.kernel_takes(3072, torch.bfloat16) and port.kernel_takes(64, torch.float32)
    assert port.kernel_takes(12, torch.bfloat16) and not port.kernel_takes(14, torch.float32)
    assert not port.kernel_takes(64, torch.float16) and not port.kernel_takes(0, torch.float32)


def test_the_autograd_op_hands_the_kernels_16_byte_aligned_tensors():
    """The forward's wrapper refuses a tensor that does not start on 16 bytes; the op copies
    one."""
    view = torch.arange(2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 64)
    assert view.data_ptr() % 16
    copy = dropout.aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    dense = torch.zeros(2, 64, dtype=torch.bfloat16)
    assert dense.data_ptr() % 16 == 0 and dropout.aligned(dense) is dense

