"""The positional convolution's op (``ops/kernels/pos_conv.py``) on the CPU.

The model's ``PositionalConvEmbedding`` used to call its ``nn.Conv1d`` on the transposed view,
drop an even kernel's trailing frame and take the exact erf GELU (:func:`parent_formulation`
below). The plain version is that formulation, bit for bit in float32 and bfloat16, forward
and gradients. The kernels' autograd op runs here with its two wrappers replaced by a plain
statement of the kernels' contract on their own layouts (:func:`contract_fwd`,
:func:`contract_bwd`: the re-laid weights, the sliding window, the dW partials' order), and is
held to the parent's formulation in float64: outputs and the gradients of x, W and b, at
kernels both even and odd, 2 and 16 groups, 16, 48 and 64 channels a group, T shorter and
longer than the kernel. The module keeps ``nn.Conv1d``'s parameters, so state dicts and the
HF reader are unchanged; the width check refuses what the kernels do not take; and on the
CPU no kernel is launched or counted. The kernels themselves are held to the plain version
by ``chip_smoke.py``'s phase ``pos_conv`` on the card.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wav2vec_heart_sounds_tpu_torch.models import hf_port
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (PositionalConvEmbedding,
                                                            Wav2Vec2Config, Wav2Vec2Model)
from wav2vec_heart_sounds_tpu_torch.ops.kernels import pos_conv
from wav2vec_heart_sounds_tpu_torch.utils import observe

# (groups, channels a group, kernel, T): even and odd kernels, T below and above the kernel.
CASES = [(2, 16, 16, 5), (2, 16, 16, 37), (2, 16, 15, 9), (16, 48, 128, 40),
         (16, 48, 7, 30), (16, 64, 12, 20), (2, 64, 5, 3), (16, 48, 128, 130)]


SQRT2 = math.sqrt(2.0)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def windows(x: torch.Tensor, groups: int, k: int, pad: int) -> torch.Tensor:
    """``x [B, T, D]`` -> ``[B, T, G, C, K]``, element ``[b, t, g, c, j] = x[b, t + j - pad,
    gC + c]``, zero outside ``[0, T)``."""
    B, t, d = x.shape
    xp = F.pad(x.reshape(B, t, groups, d // groups), (0, 0, 0, 0, pad, k - 1 - pad))
    return xp.unfold(1, k, 1)


def slide_reference(inp: torch.Tensor, wr: torch.Tensor, pad: int) -> torch.Tensor:
    """The sliding-window product of ``pos_conv_slide_kernel`` in float32:
    ``out[b, t, gC + n] = sum_{j, c} inp[b, t + j - pad, gC + c] wr[g, j, n, c]``."""
    groups, k, c = wr.shape[0], wr.shape[1], wr.shape[2]
    win = windows(inp.float(), groups, k, pad)
    out = torch.einsum("btgcj,gjnc->btgn", win, wr[..., :c].float())
    return out.reshape(inp.shape)


def dw_reference(x: torch.Tensor, dpre: torch.Tensor, groups: int, k: int) -> torch.Tensor:
    """``dW`` in float32 through the kernels' partial layout ``[G, K, C, C]``
    (``[g, j, o, c] = sum_{b, t} dpre[b, t, gC + o] x[b, t + j - K // 2, gC + c]``), re-laid as
    the reduce pass does to ``[D, C, K]``."""
    B, t, d = x.shape
    c = d // groups
    win = windows(x.float(), groups, k, k // 2)
    parts = torch.einsum("btgo,btgcj->gjoc", dpre.float().reshape(B, t, groups, c), win)
    return parts.permute(0, 2, 3, 1).reshape(d, c, k)


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """The exact erf GELU's gradient, float64 on the way, float32 out."""
    xd = x.double()
    return (0.5 * (1.0 + torch.erf(xd / SQRT2)) + xd * torch.exp(-0.5 * xd * xd)
            * INV_SQRT_2PI).float()


def contract_fwd(x, w, b, groups):
    """``pos_conv_fwd_kernel``'s contract in plain PyTorch: ``(out, pre)`` in ``x.dtype``."""
    k = w.shape[-1]
    y = slide_reference(x, pos_conv.relay_weight(w, groups), k // 2)
    if b is not None:
        y = y + b.float()
    return F.gelu(y).to(x.dtype), y.to(x.dtype)


def contract_bwd(x, w, pre, g, groups, need_dx=True, need_dw=True, need_db=True):
    """``pos_conv_bwd_kernel``'s contract in plain PyTorch: ``(dx, dw, db)`` in the input
    dtypes from ``dpre`` rounded to ``x.dtype``, float32 sums."""
    k = w.shape[-1]
    dpre = (g.float() * gelu_erf_grad(pre)).to(x.dtype)
    dx = slide_reference(dpre, pos_conv.relay_weight(w, groups, flip=True), k - 1 - k // 2)
    dw = dw_reference(x, dpre, groups, k)
    return (dx.to(x.dtype) if need_dx else None, dw.to(w.dtype) if need_dw else None,
            dpre.float().sum((0, 1)).to(w.dtype) if need_db else None)


@pytest.fixture
def contract_kernels(monkeypatch):
    """The autograd op's two kernel wrappers replaced by their contract in plain PyTorch."""
    monkeypatch.setattr(pos_conv, "pos_conv_fwd_kernel", contract_fwd)
    monkeypatch.setattr(pos_conv, "pos_conv_bwd_kernel", contract_bwd)


def parent_formulation(conv: torch.nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """The module's forward before the op: ``nn.Conv1d`` on the transposed view."""
    h = conv(x.transpose(1, 2))
    if conv.kernel_size[0] % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h, approximate="none").transpose(1, 2)


def _parent64(conv, x, w, b):
    """The parent's formulation on given leaves (float64 in the comparisons)."""
    k = w.shape[-1]
    h = F.conv1d(x.transpose(1, 2), w, b, padding=k // 2, groups=conv.groups)
    if k % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h).transpose(1, 2)


def _conv(groups: int, c: int, k: int, dtype=torch.float32, seed: int = 0) -> torch.nn.Conv1d:
    torch.manual_seed(seed)
    d = groups * c
    conv = torch.nn.Conv1d(d, d, k, padding=k // 2, groups=groups, dtype=dtype)
    with torch.no_grad():       # weights of the scale that keeps the GELU off its linear tail
        conv.weight.copy_(torch.randn(d, c, k) / (c * k) ** 0.5)
        conv.bias.copy_(0.1 * torch.randn(d))
    return conv


def _inputs(B: int, t: int, d: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(B, t, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, t, d)).astype(np.float32)))


def _value_and_grads(fn, x, w, b, g):
    leaves = [v.detach().clone().requires_grad_() for v in (x, w, b)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    return [out.detach(), *grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups,c,k,t", CASES[:4])
def test_plain_version_is_the_parent_formulation_bit_for_bit(groups, c, k, t, dtype):
    conv = _conv(groups, c, k, dtype)
    x, g = (v.to(dtype) for v in _inputs(2, t, groups * c))
    leaf = x.clone().requires_grad_()
    ref = parent_formulation(conv, leaf)
    want = [ref.detach(), *torch.autograd.grad(ref, [leaf, conv.weight, conv.bias], g)]
    got = _value_and_grads(lambda x, w, b: pos_conv.pos_conv_gelu_plain(x, w, b, groups),
                           x, conv.weight, conv.bias, g)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_module_forward_is_the_parent_formulation_bit_for_bit(dtype):
    cfg = Wav2Vec2Config.tiny()
    module = PositionalConvEmbedding(cfg, dtype)
    x, g = (v.to(dtype) for v in _inputs(3, 21, cfg.hidden_size))
    leaf = x.clone().requires_grad_()
    out = module(leaf)
    out.backward(g)
    got = [out.detach(), leaf.grad, module.conv.weight.grad, module.conv.bias.grad]
    module.zero_grad()
    leaf = x.clone().requires_grad_()
    ref = parent_formulation(module.conv, leaf)
    ref.backward(g)
    want = [ref.detach(), leaf.grad, module.conv.weight.grad, module.conv.bias.grad]
    for a, e in zip(got, want):
        assert torch.equal(a, e)


@pytest.mark.parametrize("groups,c,k,t", CASES)
def test_autograd_op_matches_the_parent_formulation_in_float64(groups, c, k, t,
                                                               contract_kernels):
    """The autograd op on the kernels' contract (float32 here, so no rounding point but the
    sums' order) against the parent's formulation in float64: out, dx, dW and db."""
    conv = _conv(groups, c, k, torch.float64)
    x, g = _inputs(2, t, groups * c)
    want = _value_and_grads(lambda x, w, b: _parent64(conv, x, w, b), x.double(),
                            conv.weight.detach(), conv.bias.detach(), g.double())
    w32, b32 = conv.weight.detach().float(), conv.bias.detach().float()
    got = _value_and_grads(lambda x, w, b: pos_conv._PosConvGelu.apply(x, w, b, groups),
                           x, w32, b32, g)
    for name, a, e in zip(("out", "dx", "dw", "db"), got, want):
        scale = e.abs().max().item()
        err = (a.double() - e).abs().max().item()
        assert a.dtype == torch.float32 and a.shape == e.shape, name
        assert err <= 2e-6 * max(scale, 1.0), (name, err, scale)


@pytest.mark.parametrize("groups,c,k,t", [CASES[1], CASES[3], CASES[5]])
def test_autograd_op_in_bfloat16_within_its_rounding(groups, c, k, t, contract_kernels):
    """bfloat16: pre and out one rounding from the float64 value (a bf16 ulp is 2^-7 of the
    value); dx, dW and db carry dpre's rounding too, per term 2^-9 and partly cancelling:
    within 1e-2 of their largest value."""
    conv = _conv(groups, c, k, torch.float64)
    x, g = (v.to(torch.bfloat16) for v in _inputs(2, t, groups * c))
    w, b = conv.weight.detach().to(torch.bfloat16), conv.bias.detach().to(torch.bfloat16)
    want = _value_and_grads(lambda x, w, b: _parent64(conv, x, w, b), x.double(), w.double(),
                            b.double(), g.double())
    got = _value_and_grads(lambda x, w, b: pos_conv._PosConvGelu.apply(x, w, b, groups),
                           x, w, b, g)
    out, ref = got[0].double(), want[0]
    assert got[0].dtype == torch.bfloat16
    assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + 1e-3 * ref.abs().max()).all()
    for name, a, e in zip(("dx", "dw", "db"), got[1:], want[1:]):
        assert a.dtype == torch.bfloat16 and a.shape == e.shape, name
        assert (a.double() - e).abs().max() <= 1e-2 * e.abs().max(), name


def test_relay_weight_index_maps():
    groups, c, k = 2, 16, 5
    w = torch.randn(groups * c, c, k)
    fwd, dx = pos_conv.relay_weight(w, groups), pos_conv.relay_weight(w, groups, flip=True)
    assert fwd.shape == dx.shape == (groups, k, c, c + pos_conv.ROW_PAD)
    assert fwd.is_contiguous() and dx.is_contiguous()
    assert not fwd[..., c:].any() and not dx[..., c:].any()
    for g in range(groups):
        for j in range(k):
            for o in range(c):
                assert torch.equal(fwd[g, j, o, :c], w[g * c + o, :, j])
                assert torch.equal(dx[g, j, :c, o], w[g * c + o, :, k - 1 - j])


@pytest.mark.parametrize("k", [16, 15])
def test_slide_reference_is_the_conv_and_its_input_gradient(k):
    """The sliding window with the forward's weight and pad is the conv; with the flipped,
    transposed weight and pad K - 1 - K // 2 it is the conv's input gradient."""
    groups, c, t = 2, 16, 11
    w = torch.randn(groups * c, c, k, dtype=torch.float64)
    x, g = (v.double() for v in _inputs(2, t, groups * c))
    y = slide_reference(x, pos_conv.relay_weight(w, groups), k // 2).double()
    ref = F.conv1d(x.transpose(1, 2), w, padding=k // 2, groups=groups)[..., :t].transpose(1, 2)
    assert torch.allclose(y, ref, atol=1e-5)
    dx = slide_reference(g, pos_conv.relay_weight(w, groups, flip=True),
                                  k - 1 - k // 2).double()
    leaf = x.clone().requires_grad_()
    conv = F.conv1d(leaf.transpose(1, 2), w, padding=k // 2, groups=groups)[..., :t]
    conv.transpose(1, 2).backward(g)
    assert torch.allclose(dx, leaf.grad, atol=1e-5)


def test_state_dict_keys_and_shapes_unchanged():
    for cfg in (Wav2Vec2Config.tiny(), Wav2Vec2Config()):
        module = PositionalConvEmbedding(cfg, torch.float32)
        d, k, groups = cfg.hidden_size, cfg.pos_conv_kernel, cfg.pos_conv_groups
        shapes = {n: tuple(v.shape) for n, v in module.state_dict().items()}
        assert shapes == {"conv.weight": (d, d // groups, k), "conv.bias": (d,)}
        assert module.conv.groups == groups and module.conv.padding == (k // 2,)


def test_hf_layout_weight_loads_through_the_pretrained_reader():
    """A legacy weight-normed HF positional conv (``weight_g [1, 1, K]``, ``weight_v``) loads
    into the module's ``conv.weight`` as ``g v / |v|`` and the model runs on it."""
    cfg = Wav2Vec2Config.tiny()
    model = Wav2Vec2Model(cfg, torch.float32)
    sd = {n: v.clone() for n, v in model.state_dict().items()}
    pos = "encoder.pos_conv_embed.conv."
    v = torch.randn_like(sd.pop(pos + "weight"))
    gain = torch.rand(1, 1, cfg.pos_conv_kernel) + 0.5
    sd[pos + "weight_g"], sd[pos + "weight_v"] = gain, v
    hf_port.load_hf_state_dict(model, sd)
    want = gain.double() * v.double() / v.double().pow(2).sum((0, 1), keepdim=True).sqrt()
    got = model.state_dict()[pos + "weight"]
    assert got.shape == v.shape and torch.allclose(got.double(), want, atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 400)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(model(x)).all()


WIDTH_CASES = {(768, 16): True, (1024, 16): True, (32, 2): True, (128, 8): True,
               (40, 2): False, (768, 8): False, (80, 10): False, (512, 16): False,
               (4096, 64): False}


@pytest.mark.parametrize("d,groups", sorted(WIDTH_CASES))
def test_width_check(d, groups):
    """The kernels take 16, 48 or 64 channels a group (the test config, base, large); 20, 96
    and 8, which are not multiples of 16, raise, so does 32, which has no instance, and so
    does a row wider than the dpre pass takes."""
    assert pos_conv.kernel_takes(d, groups) is WIDTH_CASES[(d, groups)]
    if WIDTH_CASES[(d, groups)]:
        assert pos_conv.check_widths("op", d, groups) == d // groups
    else:
        with pytest.raises(ValueError, match="channels a group"):
            pos_conv.check_widths("op", d, groups)


def test_cpu_launches_and_counts_nothing():
    """On the CPU neither the module (float32 and bfloat16) nor the op launches a kernel, and
    under a profiler the counter ``posconv.launches`` stays unrecorded."""
    cfg = Wav2Vec2Config.tiny()
    fwd, bwd = pos_conv.pos_conv_fwd_kernel, pos_conv.pos_conv_bwd_kernel
    before = (fwd.launches, bwd.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        start = observe.clock()
        for dtype in (torch.float32, torch.bfloat16):
            module = PositionalConvEmbedding(cfg, dtype)
            x = torch.randn(2, 9, cfg.hidden_size, dtype=dtype, requires_grad=True)
            module(x).sum().backward()
            w, b = module.conv.weight, module.conv.bias
            pos_conv.pos_conv_gelu(x, w, b, cfg.pos_conv_groups).sum().backward()
            assert not pos_conv.takes_kernel(x)
        counted = observe.counters(start, observe.clock())
    assert (fwd.launches, bwd.launches) == before == (0, 0)
    assert "posconv.launches" not in counted


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 5, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pos_conv.pos_conv_fwd_kernel(x, w, None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pos_conv.pos_conv_bwd_kernel(x, w, x, x, 2)
