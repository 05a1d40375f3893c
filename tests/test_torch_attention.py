"""Plain PyTorch packed-QKV attention vs the JAX Pallas kernel (interpret mode, rate 0).

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it to the plain
version there); these tests pin the plain version, which is the kernel's contract, and
the wrapper's dispatch and argument checks.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas.attention import flash_attention_qkv as jax_attention
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention as port

SEED = jnp.asarray(0, jnp.int32)


def _qkv(b, h, t, d, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, 3 * h, t, d)).astype(np.float32)


@pytest.mark.parametrize("b,h,t,d,keys", [
    (2, 3, 57, 16, None), (2, 3, 57, 16, 40),       # tiny, ragged T
    (1, 12, 40, 64, None), (1, 12, 40, 64, 33),     # the model's head geometry
    (2, 1, 8, 32, 1),                                # a single unmasked key
])
def test_reference_matches_pallas_interpret(b, h, t, d, keys):
    x = _qkv(b, h, t, d, seed=t + d)
    ref = np.asarray(jax_attention(jnp.asarray(x), SEED, 0.0, keys, True))
    out = port.attention_qkv_reference(torch.from_numpy(x), keys).numpy()
    assert out.shape == ref.shape == (b, h, t, d)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_cpu_tensor_dispatches_to_plain(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("the CUDA kernel must not run for a CPU tensor")

    monkeypatch.setattr(port, "attention_qkv_fwd", no_kernel)
    x = torch.from_numpy(_qkv(1, 2, 10, 16))
    torch.testing.assert_close(port.flash_attention_qkv(x, 7),
                               port.attention_qkv_reference(x, 7), rtol=0, atol=0)


def test_dropout_rate_raises():
    x = torch.from_numpy(_qkv(1, 2, 10, 16))
    with pytest.raises(NotImplementedError, match="dropout"):
        port.flash_attention_qkv(x, None, dropout_rate=0.1)


def test_kernel_wrapper_rejects_cpu_tensor():
    launches = port.attention_qkv_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_qkv_fwd(torch.from_numpy(_qkv(1, 2, 10, 16)))
    assert port.attention_qkv_fwd.launches == launches


def test_reference_keeps_input_dtype_with_f32_math():
    x = torch.from_numpy(_qkv(1, 2, 12, 16)).to(torch.bfloat16)
    out = port.attention_qkv_reference(x, 9)
    assert out.dtype == torch.bfloat16
    f32 = port.attention_qkv_reference(x.float(), 9)
    torch.testing.assert_close(out.float(), f32, atol=1e-2, rtol=1e-2)
