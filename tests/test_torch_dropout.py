"""Philox dropout bits, the GELU forms, and dropout (K1): the port's plain versions.

The CUDA kernels run only on a card (``chip_smoke.py`` holds each to its plain version
there, masks bit for bit); these tests pin the plain versions, which are the kernels'
contract:

* Philox4x32-10 against Random123's known-answer vectors, a mask that is a function of
  the element index alone, and a keep rate within 3 sigma of ``1 - rate``;
* the GELU helpers against the JAX package's (``ops/pallas/conv.py``), float32;
* the GELU forms on the CPU kept off MKL's vector math (whose first call in a process can
  return one thread's chunk at ~13-bit accuracy), and the erf form within the rational erf's
  stated error of the exact GELU in float64;
* dropout at rate 0 against the Pallas kernel in interpret mode, and at rate 0.1 with the
  port's mask injected into the JAX composition ``where(keep, x / (1 - r), 0)``, values
  and ``jax.vjp`` gradients, also at odd lengths and on a view one element past 16 bytes;
  forward and backward apply the same mask;
* K2's alignment check, which refuses a view that does not start on 16 bytes.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas import conv as jax_conv
from wav2vec_heart_sounds_tpu.ops.pallas.dropout import prng_dropout
from wav2vec_heart_sounds_tpu_torch.ops import gelu, philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout as port

RATE = 0.1


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's kat_vectors for philox4x32_10."""
    words = philox.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in words) == expected


def test_philox_bits_are_a_function_of_the_index():
    """Any split of the index range gives the same bits: element i is word i & 3 of
    counter i >> 2 (a tile starting mid-group must find its bits where the plain does)."""
    full = philox.bits(7, 3, 103)
    assert full.min() >= 0 and full.max() <= philox.MASK32
    g = torch.arange(26, dtype=torch.int64)
    zero = torch.zeros_like(g)
    words = torch.stack(philox.philox4x32(g, zero, zero, zero, 7, 3), dim=1).reshape(-1)
    torch.testing.assert_close(full, words[:103], rtol=0, atol=0)
    torch.testing.assert_close(philox.bits(7, 3, 50), full[:50], rtol=0, atol=0)
    assert not torch.equal(philox.bits(7, 4, 103), full)      # another site, other bits
    assert not torch.equal(philox.bits(8, 3, 103), full)      # another seed, other bits


def test_keep_mask_threshold_and_rate():
    assert philox.threshold(0.0) == 0 and philox.threshold(1.0) == 2 ** 32 - 1
    assert philox.threshold(RATE) == int(np.uint32(RATE * np.iinfo(np.uint32).max))
    n = 200_000
    keep = philox.keep_mask(11, 5, (n,), RATE)
    sigma = np.sqrt(n * RATE * (1 - RATE))
    assert abs(int(keep.sum()) - n * (1 - RATE)) < 3 * sigma
    assert bool(philox.keep_mask(11, 5, (3, 4), 0.0).all())
    torch.testing.assert_close(philox.keep_mask(11, 5, (40, 5), RATE).reshape(-1),
                               keep[:200], rtol=0, atol=0)


@pytest.mark.parametrize("port_fn,jax_fn", [
    (gelu.gelu_erf, jax_conv._gelu_exact), (gelu.gelu_erf_grad, jax_conv._gelu_grad_kernel),
    (gelu.gelu_tanh, jax_conv._gelu_tanh), (gelu.gelu_tanh_grad, jax_conv._gelu_tanh_grad),
])
def test_gelu_forms_match_jax(port_fn, jax_fn):
    x = np.concatenate([np.linspace(-6, 6, 1001), [0.0]]).astype(np.float32)
    ref = np.asarray(jax_fn(jnp.asarray(x)))
    # torch's and XLA's float32 exp/tanh differ in ulps; 1 - tanh^2 magnifies that to ~4e-6
    np.testing.assert_allclose(port_fn(torch.from_numpy(x)).numpy(), ref, atol=1e-5)


def test_gelu_erf_is_within_rational_error_of_exact():
    x = torch.linspace(-5, 5, 401)
    # 0.5 |x| * 1.5e-7 <= 3.8e-7 at |x| <= 5, plus float32 rounding of values up to 5
    torch.testing.assert_close(gelu.gelu_erf(x), torch.nn.functional.gelu(x), atol=1e-6,
                               rtol=0)


FORMS = ("gelu_erf", "gelu_erf_grad", "gelu_tanh", "gelu_tanh_grad")


@pytest.mark.parametrize("form", FORMS)
def test_gelu_forms_on_the_cpu_stay_off_mkl_vector_math(form, monkeypatch):
    """torch.exp and torch.tanh on CPU tensors go to MKL, whose first call in a process can
    compute one OpenMP thread's chunk at ~13-bit accuracy; the plain forms must not call them
    there (a CPU result that depends on the intra-op chunking)."""
    x = torch.linspace(-6, 6, 40001)                 # above the intra-op grain: chunked
    want = getattr(gelu, form)(x)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU GELU form called MKL's vector exp or tanh")

    monkeypatch.setattr(torch, "exp", refuse)
    monkeypatch.setattr(torch, "tanh", refuse)
    torch.testing.assert_close(getattr(gelu, form)(x), want, rtol=0, atol=0)


def test_gelu_erf_is_within_rational_error_of_float64():
    """The float32 erf GELU against 0.5 x (1 + erf(x / sqrt 2)) in float64: within the
    rational erf's stated 1.5e-7 (times 0.5 |x|) plus four float32 roundings at x's scale."""
    x = np.linspace(-6, 6, 20001).astype(np.float32)
    xd = x.astype(np.float64)
    exact = 0.5 * xd * (1.0 + np.vectorize(math.erf)(xd / math.sqrt(2.0)))
    got = gelu.gelu_erf(torch.from_numpy(x)).numpy().astype(np.float64)
    bar = 0.5 * np.abs(xd) * 1.5e-7 + 4 * 2.0 ** -24 * np.maximum(1.0, np.abs(xd))
    assert np.all(np.abs(got - exact) <= bar), float(np.max(np.abs(got - exact) - bar))


def _x(shape=(37, 24), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_dropout_rate0_matches_pallas_interpret():
    x = _x()
    g = _x(seed=1)
    ref, vjp = jax.vjp(lambda a: prng_dropout(a, jnp.asarray(0, jnp.int32), 0.0, True),
                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port.dropout(xt, 5, 1, 0.0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)


@pytest.mark.parametrize("shape", [(37, 24), (2, 5, 17)])
def test_dropout_with_injected_mask_matches_jax_composition(shape):
    x, g = _x(shape), _x(shape, seed=1)
    keep = philox.keep_mask(123, 4, shape, RATE).numpy()
    ref, vjp = jax.vjp(lambda a: jnp.where(keep, a / (1.0 - RATE), 0.0), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port.dropout(xt, 123, 4, RATE)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)
    # forward and backward dropped the same elements
    np.testing.assert_array_equal(out.detach().numpy() != 0, keep)
    np.testing.assert_array_equal(xt.grad.numpy() != 0, keep)


@pytest.mark.parametrize("n,offset", [(101, 0), (1001, 1), (4099, 3)])
def test_dropout_odd_lengths_and_offset_views_match_jax_composition(n, offset):
    """Odd lengths, on views 0, 1 and 3 elements past 16 bytes: the mask is the element's index
    in the view, whatever its storage."""
    base = _x((n + offset,), seed=n)
    x, g = base[offset:], _x((n,), seed=n + 1)
    keep = philox.keep_mask(77, 3, (n,), RATE).numpy()
    ref, vjp = jax.vjp(lambda a: jnp.where(keep, a / (1.0 - RATE), 0.0), jnp.asarray(x))
    xt = torch.from_numpy(base).requires_grad_()
    view = xt[offset:]
    assert view.data_ptr() % 16 == 4 * offset % 16
    out = port.dropout(view, 77, 3, RATE)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy()[offset:], np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5)
    torch.testing.assert_close(out.detach(), port.dropout_reference(view.detach().clone(), 77, 3,
                                                                    RATE), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_alignment_check_refuses_an_offset_view(dtype):
    """K2's wrappers refuse a view one element past 16 bytes (its rows move by bulk copies);
    K1 takes any contiguous tensor (above)."""
    flat = torch.zeros(2 * 768 + 16, dtype=dtype)
    start = -flat.data_ptr() % port.VECTOR_BYTES // flat.element_size()
    aligned = flat[start:start + 2 * 768].view(2, 768)
    offset = flat[start + 1:start + 1 + 2 * 768].view(2, 768)
    port.check_aligned("resid_fwd_kernel", aligned)
    with pytest.raises(ValueError, match="16 bytes"):
        port.check_aligned("resid_fwd_kernel", aligned, offset)


def test_dropout_bf16_rounds_once():
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    out = port.dropout_reference(x, 9, 2, RATE)
    keep = philox.keep_mask(9, 2, x.shape, RATE)
    assert out.dtype == torch.bfloat16
    expected = torch.where(keep, x.float() * philox.keep_scale(RATE), 0.0).to(torch.bfloat16)
    torch.testing.assert_close(out, expected, rtol=0, atol=0)


def test_dropout_cpu_dispatch_and_kernel_wrapper_checks(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("the CUDA kernel must not run for a CPU tensor")

    launches = port.dropout_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.dropout_kernel(torch.zeros(4, 4), 0, 0, RATE)
    assert port.dropout_kernel.launches == launches
    monkeypatch.setattr(port, "dropout_kernel", no_kernel)
    x = torch.from_numpy(_x())
    torch.testing.assert_close(port.dropout(x, 1, 2, RATE),
                               port.dropout_reference(x, 1, 2, RATE), rtol=0, atol=0)
