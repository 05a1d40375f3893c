"""Residual tail ``LayerNorm(x + dropout(h))`` (K2): the port's plain versions vs the JAX package.

At rate 0 against the Pallas kernel in interpret mode (forward and VJP, f32 atol 1e-5),
also at the widths the kernels' lanes treat apart (128, 384 and 768 columns: whole, half
and idle last passes) with ragged row counts (1, 127, and one that is not a multiple of a
tile); at rate 0.1 with the port's Philox mask injected into the JAX composition
(``reference_dropout_add_layernorm``'s formula with ``where(keep, ...)``), values and
``jax.vjp`` gradients. The backward kernel's partition of rows into tiles and tiles into
blocks covers every row once, and its per-block partial sums, added in the wrapper's order,
are the plain column sums. The CUDA kernels are held to these plain versions by
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


# Rows a tile holds in the kernels (csrc/resid.cuh, kResidRows).
ROWS_PER_TILE = 8


@pytest.mark.parametrize("rows", [1, 127, 2 * ROWS_PER_TILE + 3])
@pytest.mark.parametrize("cols", [128, 384, 768])
def test_rate0_matches_pallas_interpret_at_kernel_widths(rows, cols):
    h, x, w, b, g = _inputs((rows, cols), seed=rows + cols)
    seed = jnp.asarray(0, jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_resid(*a, seed, 0.0, EPS, True),
                       *map(jnp.asarray, (h, x, w, b)))
    out, grads = _port(h, x, w, b, g, 3, 7, 0.0)
    _compare(out, grads, ref, vjp(jnp.asarray(g)), 1e-5)


def _block_of_rows(rows: int, blocks: int, rows_per_tile: int) -> torch.Tensor:
    """The block of the persistent grid that takes each row: tile ``row // rows_per_tile``
    goes to block ``tile % blocks``."""
    return torch.arange(rows) // rows_per_tile % blocks


def _block_partials(g, s, blocks: int, rows_per_tile: int) -> torch.Tensor:
    """The backward kernel's float32 partials ``[2, blocks, cols]`` in plain PyTorch: for each
    block the column sums of ``g * shat`` (dweight) and of ``g`` (dbias) over its rows."""
    c = g.shape[-1]
    sf, gf = s.reshape(-1, c).float(), g.reshape(-1, c).float()
    mean = sf.mean(-1, keepdim=True)
    var = ((sf * sf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    shat = (sf - mean) * torch.rsqrt(var + EPS)
    owner = _block_of_rows(sf.shape[0], blocks, rows_per_tile)
    parts = torch.zeros((2, blocks, c), dtype=torch.float32)
    parts[0].index_add_(0, owner, gf * shat)
    parts[1].index_add_(0, owner, gf)
    return parts


def _kernel_walk(rows: int, blocks: int, rows_per_tile: int) -> dict[int, list[int]]:
    """The rows each block takes in ``csrc/resid.cuh``'s loops: tiles t = block, block +
    blocks, ... below ceil(rows / R), rows t R .. min((t + 1) R, rows) - 1 of each."""
    tiles = -(-rows // rows_per_tile)
    return {b: [r for t in range(b, tiles, blocks)
                for r in range(t * rows_per_tile, min((t + 1) * rows_per_tile, rows))]
            for b in range(blocks)}


@pytest.mark.parametrize("rows,blocks,rows_per_tile", [
    (1, 132, 8), (127, 132, 8), (19, 2, 8), (1000, 264, 8), (1000, 7, 16), (3264, 264, 8)])
def test_backward_partition_and_partials(rows, blocks, rows_per_tile):
    walk = _kernel_walk(rows, blocks, rows_per_tile)
    covered = sorted(r for taken in walk.values() for r in taken)
    assert covered == list(range(rows))                       # every row once
    owner = _block_of_rows(rows, blocks, rows_per_tile)
    for b, taken in walk.items():
        assert bool((owner[taken] == b).all())
    h, x, w, b_, g = _inputs((rows, 256), seed=rows)
    s = port.dropout_add_reference(torch.from_numpy(h), torch.from_numpy(x), 9, 4, RATE)
    gt = torch.from_numpy(g)
    parts = _block_partials(gt, s, blocks, rows_per_tile)
    assert parts.shape == (2, blocks, 256) and parts.dtype == torch.float32
    _, _, dweight, dbias = port.resid_bwd_reference(gt, s, torch.from_numpy(w), 9, 4, RATE, EPS)
    got_w, got_b = parts.sum(dim=1)                          # the wrapper's order
    # chip_smoke's colsum bar for float32 sums over rows in another order
    torch.testing.assert_close(got_w, dweight, atol=1e-2, rtol=1e-4)
    torch.testing.assert_close(got_b, dbias, atol=1e-2, rtol=1e-4)


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
