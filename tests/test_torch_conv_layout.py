"""K8's bfloat16 layout on the CPU: the frame view, the re-laid weights, the padded dpre, and
the three GEMMs as the card's kernels compute them.

On the card the bfloat16 K8 (``csrc/conv_gelu.cu``) packs x once into the JAX kernel's frame
view and runs three GEMMs whose tap shifts are shifts of the rows a k step reads. This file
holds a plain model of each piece: the plain frame view (:func:`pack_frames_reference`), the
weight re-lays (:func:`relay_weight`, :func:`relay_weight_dx`) and the padded channels-last
dpre (:func:`dpre_frames_reference`) against their definitions; then the forward as one
product of ``wr`` with the frame view (tap 2 at row n + 1, zero past the last row, the frame
past ``out_len`` computed and dropped), dx as the even rows' and odd rows' products with the
padded dpre (tap 2 at row u - 1: the previous batch's zero pad, or zero before the first
row), and dW as float32 partials over ranges of (batch, 64-frame) steps summed in order.
Each model runs in float32 against the plain ``conv_gelu_{fwd,bwd}_reference`` (forward atol
2e-5 / rtol 1e-5, the bar of ``tests/test_torch_conv.py``; gradients atol 1e-5 of their
largest value, rtol 1e-5: float32 sums in another order) and against the JAX
``reference_conv_gelu`` and its ``jax.vjp`` (that file's bars: forward 2e-5 / 1e-5, gradients
5e-4 / 1e-4). T odd and even, Cin != Cout, and batches whose frame count is not a multiple of
the 128-frame tiles. The card holds the kernels to the plain versions (``chip_smoke.py``
phase 14: the frame view and the padded dpre bit for bit).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_heart_sounds_tpu.ops.pallas.conv import reference_conv_gelu
from wav2vec_heart_sounds_tpu_torch.ops import gelu
from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv as port

CASES = [(3, 128, 256, 259), (2, 256, 128, 260), (1, 128, 128, 3), (2, 128, 128, 301)]


def _inputs(b, cin, cout, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cin, t)).astype(np.float32)
    w = (rng.normal(size=(cout, cin, 3)) / math.sqrt(3 * cin)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _next_rows(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """``rows[n + shift]`` for every n, zero outside (a tensor map's fill)."""
    out = torch.zeros_like(rows)
    if shift > 0:
        out[:-shift] = rows[shift:]
    else:
        out[-shift:] = rows[:shift]
    return out


def forward_model(x, w):
    """``(out, pre)`` as the forward GEMM: M = Cout, N = the frame-view rows, K = 3 Cin."""
    B, cin, t = x.shape
    out_len = port.out_length(t)
    rows = port.pack_frames_reference(x).reshape(-1, 2 * cin)          # [B (U + 1), 2 Cin]
    operand = torch.cat([rows, _next_rows(rows, 1)[:, :cin]], dim=1)   # k = tap Cin + c
    y = port.relay_weight(w) @ operand.T                                # [Cout, B (U + 1)]
    y = y.reshape(-1, B, out_len + 1)[:, :, :out_len].permute(1, 0, 2)  # the junk frame dropped
    return gelu.gelu_erf(y), y


def dx_model(w, dpre_t, t):
    """dx as the dx GEMM: even rows from taps 0 (frame u) and 2 (frame u - 1), odd rows from
    tap 1 (frame u), over the padded channels-last dpre."""
    B, pad, cout = dpre_t.shape
    cin = w.shape[1]
    rows = dpre_t.reshape(-1, cout)
    wx = port.relay_weight_dx(w).reshape(cin // 64, 3, 64, cout)
    w0, w1, w2 = (wx[:, j].reshape(cin, cout) for j in range(3))
    even = w0 @ rows.T + w2 @ _next_rows(rows, -1).T                    # [Cin, B P]
    odd = w1 @ rows.T
    dx = torch.stack([even, odd], dim=-1).reshape(cin, B, 2 * pad).permute(1, 0, 2)
    return dx[:, :, :t]


def dw_model(dpre_t, xf, n_parts):
    """dW as the dW GEMM: float32 partials over ranges of the (batch, 64-frame) k steps,
    A = dpre_t's rows (M-major), B = the frame view's rows (tap 2 at row + 1), summed in
    order, then re-laid from [Cout, 3 Cin] to [Cout, Cin, 3]."""
    B, pad, cout = dpre_t.shape
    frames, cin = xf.shape[1], xf.shape[2] // 2
    flat = torch.cat([xf.reshape(-1, 2 * cin), torch.zeros(pad + 1, 2 * cin)])
    steps = [(b, t0) for b in range(B) for t0 in range(0, pad, port.FRAME_STEP)]
    chunk = -(-len(steps) // n_parts)
    parts = []
    for p in range(0, len(steps), chunk):
        acc = torch.zeros(cout, 3 * cin)
        for b, t0 in steps[p:p + chunk]:
            a = dpre_t[b, t0:t0 + port.FRAME_STEP]                           # [64, Cout]
            r = b * frames + t0
            operand = torch.cat([flat[r:r + port.FRAME_STEP],
                                 flat[r + 1:r + 1 + port.FRAME_STEP, :cin]], dim=1)
            acc += a.T @ operand
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.reshape(cout, 3, cin).permute(0, 2, 1)


@pytest.mark.parametrize("t", [259, 260, 3])
def test_frame_view_holds_the_pairs_and_the_last_tap(t):
    x, _ = _inputs(2, 128, 128, t)
    out_len = port.out_length(t)
    xf = port.pack_frames_reference(x)
    assert xf.shape == (2, out_len + 1, 256)
    u = torch.arange(out_len + 1)
    for j in (0, 1):
        s = 2 * u + j
        inside = s < t
        got = xf[:, :, j * 128:(j + 1) * 128]
        torch.testing.assert_close(got[:, inside], x[:, :, s[inside]].transpose(1, 2),
                                   rtol=0, atol=0)
        assert not got[:, ~inside].any()                       # zeros past T
    torch.testing.assert_close(xf[:, out_len, :128], x[:, :, 2 * out_len], rtol=0, atol=0)


def test_relaid_weights_follow_their_index_maps():
    _, w = _inputs(1, 256, 128, 9)
    wr, wx = port.relay_weight(w), port.relay_weight_dx(w)
    assert wr.shape == (128, 768) and wx.shape == (768, 128)
    assert wr.is_contiguous() and wx.is_contiguous()
    for j in range(3):
        torch.testing.assert_close(wr[:, j * 256:(j + 1) * 256], w[:, :, j], rtol=0, atol=0)
        for m in range(256 // 64):
            torch.testing.assert_close(wx[192 * m + 64 * j:192 * m + 64 * (j + 1)],
                                       w[:, 64 * m:64 * (m + 1), j].T, rtol=0, atol=0)


@pytest.mark.parametrize("out_len", [129, 130, 1, 6399])
def test_padded_dpre_rows(out_len):
    pad = port.frames_padded(out_len)
    assert pad % port.FRAME_STEP == 0 and out_len + 1 <= pad < out_len + 1 + port.FRAME_STEP
    rng = np.random.default_rng(out_len)
    pre, g = (torch.from_numpy(rng.normal(size=(2, 128, out_len)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    dpre_t = port.dpre_frames_reference(pre, g)
    assert dpre_t.shape == (2, pad, 128) and dpre_t.dtype == torch.bfloat16
    want = (g.float() * gelu.gelu_erf_grad(pre)).to(torch.bfloat16)   # the plain backward's
    torch.testing.assert_close(dpre_t[:, :out_len], want.transpose(1, 2), rtol=0, atol=0)
    assert not dpre_t[:, out_len:].any()                     # the pad rows, frame out_len on


@pytest.mark.parametrize("b,cin,cout,t", CASES)
def test_forward_gemm_model(b, cin, cout, t):
    x, w = _inputs(b, cin, cout, t, seed=t)
    out, pre = forward_model(x, w)
    ref_out, ref_pre = port.conv_gelu_fwd_reference(x, w)
    torch.testing.assert_close(pre, ref_pre, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=1e-5)
    jax_out = reference_conv_gelu(jnp.asarray(x.numpy().transpose(0, 2, 1)),
                                  jnp.asarray(w.numpy().transpose(2, 1, 0)), port.out_length(t))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1), np.asarray(jax_out), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n_parts", [1, 3, 7])
@pytest.mark.parametrize("b,cin,cout,t", CASES)
def test_backward_gemm_model(b, cin, cout, t, n_parts):
    x, w = _inputs(b, cin, cout, t, seed=t + 1)
    _, pre = port.conv_gelu_fwd_reference(x, w)
    g = torch.from_numpy(np.random.default_rng(t).normal(size=pre.shape).astype(np.float32))
    dpre_t = port.dpre_frames_reference(pre, g)
    out_len = port.out_length(t)
    assert (dpre_t.shape[1] - 1) >= out_len               # u = 0's row u - 1 is a pad row
    dx = dx_model(w, dpre_t, t)
    dw = dw_model(dpre_t, port.pack_frames_reference(x), n_parts)
    ref_dx, ref_dw = port.conv_gelu_bwd_reference(x, w, pre, g)
    for got, ref in ((dx, ref_dx), (dw, ref_dw)):
        torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=1e-5)
    if t > 2 * out_len + 1:
        assert not dx[:, :, 2 * out_len + 1:].any()       # rows no frame reads
    # the JAX reference's vjp at the same cotangent
    xj, wj = jnp.asarray(x.numpy().transpose(0, 2, 1)), jnp.asarray(w.numpy().transpose(2, 1, 0))
    _, vjp = jax.vjp(lambda a, c: reference_conv_gelu(a, c, out_len), xj, wj)
    want_dx, want_dw = vjp(jnp.asarray(g.numpy().transpose(0, 2, 1)))
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 1), np.asarray(want_dx), atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(dw.numpy().transpose(2, 1, 0), np.asarray(want_dw), atol=5e-4,
                               rtol=1e-4)


def test_kernel_wrappers_refuse_a_cpu_frame_view():
    x, w = _inputs(1, 128, 128, 11)
    frames = port.ConvFrames(port.pack_frames_reference(x).to(torch.bfloat16), 11)
    pre = torch.zeros(1, 128, 5, dtype=torch.bfloat16)
    before = port.conv_gelu_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.conv_gelu_bwd_kernel(frames, w.to(torch.bfloat16), pre, pre)
    assert port.conv_gelu_bwd_kernel.launches == before
