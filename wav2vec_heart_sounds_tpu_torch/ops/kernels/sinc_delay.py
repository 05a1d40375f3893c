"""Time-varying windowed-sinc fractional delay (K7): CUDA kernels, plain versions, autograd.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/beamformer.py::sinc_delay`` /
``delay_channel``. Each row of ``x [R, T]`` (float32) is delayed by its per-sample
``delays [R, T]`` through a ``K``-tap window (Hamming in the beamformer):

    u[t, k] = sinc((k - K//2) - d[t]) * w[k],   y[t] = sum_k u[t, k] xpad[t + k] / sum_k u[t, k]

with ``xpad`` the row reflect-padded by ``K//2``. The backward is analytic, as the JAX
package's: ``dd`` from ``sinc'`` (zero for ``|z| < 1e-6``), ``dx`` over the padded axis,
then the pad entries folded back into the interior. The forward saves the normaliser
``s = sum_k u`` for the ``dx`` pass.

Where the integer nearest a delay lies beyond the taps (``|rint(d)| > K//2``; the
beamformer allows delays up to 41.25 samples against 20 taps on each side) every
``u[t, k]`` carries the factor ``sin(pi d)``: ``s`` vanishes at integer delays (0 / 0) and
the float32 form is ill-conditioned near them. There the weights are taken without that
factor, ``e_k = (-1)^(c_k + 1) w_k / (pi (c_k - d))`` with derivative ``e_k / (c_k - d)``:
the same ``y`` and gradients, without the 0 / 0. Their sum still alternates in sign and
cancels (``sum |e_k xpad| / |sum e_k|`` reaches ~290 on unit inputs), so in float32 the last
bits of ``y`` depend on the order of the operations; there the weights are taken in float64
(``e_k``, ``e_k w_k``, and the derivative) from the float32 ``x`` and ``d``. Every sum (``y``'s
two, ``grad_d``'s four) is taken in float64 in tap order, and the results rounded to the
input dtype once. The kernel does the same operations with contraction forbidden, so beyond
the taps its ``y`` and ``s`` equal these bit for bit. ``sin(pi z)`` comes from one
``sin(pi d)`` per sample (``sin(pi (c - d)) = -(-1)^c sin(pi d)``), as in
``csrc/sinc_delay.cu``. On float64 inputs everything is float64: the reference the card's
checks measure both sides against.

Three entry points, each with a plain version of the same signature: the forward
(``(y, s)``), ``grad_d`` and ``grad_x`` (``dxpad [R, T + K - 1]``). :func:`delay_channel`
takes the plain versions only for CPU tensors; CUDA tensors go to ``csrc/sinc_delay.cu``
(one launch per direction for every row, all microphones of a batch included) or raise.
:func:`delay_channel_reference` is the JAX package's materialised ``[R, T, K]`` form, with
autograd, an independent check of the whole op where that form is well conditioned.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _sinc(z: torch.Tensor) -> torch.Tensor:
    """``jnp.sinc``: ``sin(pi z) / (pi z)``, 1 at 0."""
    zero = z == 0
    pz = torch.where(zero, 1.0, math.pi * z)
    return torch.where(zero, 1.0, torch.sin(pz) / pz)


def _taps(window) -> list[float]:
    return [float(w) for w in np.asarray(window, dtype=np.float32)]


def _reflect_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    return F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0]


def _sinpi_cospi(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``sin(pi d)``, ``cos(pi d)`` with exact argument reduction (``d - rint(d)``)."""
    n = torch.round(d)
    sign = 1.0 - 2.0 * torch.remainder(n, 2.0)
    r = math.pi * (d - n)
    return sign * torch.sin(r), sign * torch.cos(r)


def _tap_weights(delays: torch.Tensor, window, derivative: bool = False):
    """Per tap: ``(k, u_k, du_k / dd)`` in float64, the weighted tap in the form of each
    sample (see the module docstring). Inside the taps ``sinc(z) w_k`` and ``-sinc'(z) w_k``
    (0 for ``|z| < 1e-6``), each a product in ``delays.dtype``; beyond them the factor-free
    ``e_k w_k`` and ``e_k w_k / z``, in float64. ``du`` is None without ``derivative``."""
    taps = _taps(window)
    half = len(taps) // 2
    far = torch.round(delays).abs() > half
    sd, cd = _sinpi_cospi(delays)
    d64 = delays.double()
    for k, w in enumerate(taps):
        c = k - half
        z = float(c) - delays
        hit = z == 0
        zs = torch.where(hit, 1.0, z)
        odd = c % 2 == 1
        z64 = float(c) - d64                          # exact; |z64| >= 0.5 where far
        e = (1.0 if odd else -1.0) / (math.pi * z64)
        sinc = torch.where(hit, 1.0, (sd if odd else -sd) / (math.pi * zs))
        u = torch.where(far, e * w, (sinc * w).double())
        du = None
        if derivative:
            small = z.abs() < 1e-6
            dsinc = torch.where(small, 0.0, -((-cd if odd else cd) - sinc)
                                / torch.where(small, 1.0, z))
            du = torch.where(far, e / z64 * w, (dsinc * w).double())
        yield k, u, du


def sinc_fwd_reference(x, delays, window) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward over ``[R, T]`` rows: ``(y, s)`` in ``x.dtype`` from float64 sums."""
    K, T = len(window), x.shape[1]
    xpad = _reflect_pad(x, K // 2).double()
    acc, norm = (torch.zeros_like(delays, dtype=torch.float64) for _ in range(2))
    for k, u, _ in _tap_weights(delays, window):
        norm = norm + u
        acc = acc + u * xpad[:, k:k + T]
    return (acc / norm).to(x.dtype), norm.to(x.dtype)


def sinc_grad_d_reference(x, delays, g, window) -> torch.Tensor:
    """Plain gradient over the delays: ``g / s * sum_k u' (xpad[t + k] - y)``, float64 sums."""
    K, T = len(window), x.shape[1]
    xpad = _reflect_pad(x, K // 2).double()
    acc, norm, moment, dnorm = (torch.zeros_like(delays, dtype=torch.float64)
                                for _ in range(4))
    for k, u, du in _tap_weights(delays, window, derivative=True):
        xk = xpad[:, k:k + T]
        acc, norm = acc + u * xk, norm + u
        moment, dnorm = moment + du * xk, dnorm + du
    return (g.double() / norm * (moment - acc / norm * dnorm)).to(g.dtype)


def sinc_grad_x_reference(delays, g, s, window) -> torch.Tensor:
    """Plain gradient over the padded input: ``dxpad [R, T + K - 1]``, sample ``t`` feeding
    position ``t + k`` with ``g[t] / s[t] * u[t, k]`` (``u`` rounded to the input dtype)."""
    K, (R, T) = len(window), delays.shape
    gs = g / s
    dxpad = torch.zeros((R, T + K - 1), dtype=delays.dtype, device=delays.device)
    for k, u, _ in _tap_weights(delays, window):
        dxpad[:, k:k + T] += gs * u.to(delays.dtype)
    return dxpad


def fold_reflect(dxpad: torch.Tensor, half: int) -> torch.Tensor:
    """Gradient of the reflect padding: the pad entries add onto the samples they copied."""
    T = dxpad.shape[1] - 2 * half
    dx = dxpad[:, half:half + T].clone()
    dx[:, 1:half + 1] += dxpad[:, :half].flip(-1)
    dx[:, T - half - 1:T - 1] += dxpad[:, half + T:].flip(-1)
    return dx


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int]:
    shape = tensors[0].shape
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} needs contiguous [R, T] tensors")
    if any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: every [R, T] tensor must have the same shape")
    return shape[0], shape[1]


def _window_arg(window):
    """The C entries' taps argument; a tuple (as :func:`delay_channel` passes) is its own
    cache key, with no numpy copy."""
    return _window_array(window if isinstance(window, tuple) else tuple(_taps(window)))


@functools.lru_cache(maxsize=16)
def _window_array(taps: tuple) -> tuple:
    """The taps as the C entries take them (a ctypes array of float32, rounded as
    :func:`_taps` rounds, and its length), built once per window."""
    if len(taps) % 2 == 0 or len(taps) > 64:
        raise ValueError(f"the kernel takes an odd number of taps up to 64, got {len(taps)}")
    return (ctypes.c_float * len(taps))(*taps), len(taps)


def sinc_fwd_kernel(x, delays, window) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``csrc/sinc_delay.cu``; counts launches in ``.launches``."""
    rows, T = _check("sinc_fwd_kernel", x, delays)
    taps, K = _window_arg(window)
    y, s = torch.empty_like(x), torch.empty_like(x)
    fn = build.entry("sinc_delay", "sinc_delay_fwd", (_P, _P, _P, _P, _I, _I, _P, _I, _P))
    build.check(fn(x.data_ptr(), delays.data_ptr(), y.data_ptr(), s.data_ptr(), rows, T, taps,
                   K, build.stream(x)), "sinc_fwd_kernel")
    sinc_fwd_kernel.launches += 1
    return y, s


def sinc_grad_d_kernel(x, delays, g, window) -> torch.Tensor:
    """Launch the delay gradient of ``csrc/sinc_delay.cu``; counts launches."""
    rows, T = _check("sinc_grad_d_kernel", x, delays, g)
    taps, K = _window_arg(window)
    dd = torch.empty_like(delays)
    fn = build.entry("sinc_delay", "sinc_delay_grad_d", (_P, _P, _P, _P, _I, _I, _P, _I, _P))
    build.check(fn(x.data_ptr(), delays.data_ptr(), g.data_ptr(), dd.data_ptr(), rows, T, taps,
                   K, build.stream(x)), "sinc_grad_d_kernel")
    sinc_grad_d_kernel.launches += 1
    return dd


def sinc_grad_x_kernel(delays, g, s, window) -> torch.Tensor:
    """Launch the input gradient of ``csrc/sinc_delay.cu`` (``dxpad``); counts launches."""
    rows, T = _check("sinc_grad_x_kernel", delays, g, s)
    taps, K = _window_arg(window)
    dxpad = torch.empty((rows, T + K - 1), dtype=torch.float32, device=delays.device)
    fn = build.entry("sinc_delay", "sinc_delay_grad_x", (_P, _P, _P, _P, _I, _I, _P, _I, _P))
    build.check(fn(delays.data_ptr(), g.data_ptr(), s.data_ptr(), dxpad.data_ptr(), rows, T,
                   taps, K, build.stream(delays)), "sinc_grad_x_kernel")
    sinc_grad_x_kernel.launches += 1
    return dxpad


sinc_fwd_kernel.launches = 0
sinc_grad_d_kernel.launches = 0
sinc_grad_x_kernel.launches = 0


class _SincDelay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delays, window):
        if x.device.type == "cpu":
            y, s = sinc_fwd_reference(x, delays, window)
        else:
            y, s = sinc_fwd_kernel(x, delays, window)
        ctx.save_for_backward(x, delays, s)
        ctx.window = window
        return y

    @staticmethod
    def backward(ctx, g):
        x, delays, s = ctx.saved_tensors
        g = g.contiguous()
        cpu = g.device.type == "cpu"
        dx = dd = None
        if ctx.needs_input_grad[1]:
            dd = (sinc_grad_d_reference if cpu else sinc_grad_d_kernel)(x, delays, g, ctx.window)
        if ctx.needs_input_grad[0]:
            dxpad = (sinc_grad_x_reference if cpu else sinc_grad_x_kernel)(delays, g, s,
                                                                          ctx.window)
            dx = fold_reflect(dxpad, len(ctx.window) // 2)
        return dx, dd, None


def delay_channel(x: torch.Tensor, delays: torch.Tensor, kernel_size: int,
                  window) -> torch.Tensor:
    """Delay each row of ``x [R, T]`` by ``delays [R, T]`` through the ``kernel_size`` taps of
    ``window``; float32 in and out, differentiable in both inputs."""
    if len(window) != kernel_size:
        raise ValueError(f"window has {len(window)} taps, kernel_size is {kernel_size}")
    taps = tuple(_taps(window))
    return _SincDelay.apply(x.float().contiguous(), delays.float().contiguous(), taps)


def delay_channel_reference(x: torch.Tensor, delays: torch.Tensor, kernel_size: int,
                            window) -> torch.Tensor:
    """The JAX package's materialised form (``beamformer.py:192-202``): a ``[R, T, K]``
    kernel stack, normalised, contracted with the shifted copies; plain autograd."""
    half = kernel_size // 2
    w = torch.as_tensor(np.asarray(window, dtype=np.float32), device=x.device)
    t_idx = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
    kernel = _sinc(t_idx[None, None, :] - delays[:, :, None]) * w
    kernel = kernel / kernel.sum(dim=-1, keepdim=True)
    padded = _reflect_pad(x, half)
    T = x.shape[-1]
    shifted = torch.stack([padded[:, k:k + T] for k in range(kernel_size)], dim=-1)
    return torch.einsum("btk,btk->bt", shifted, kernel)
