"""Causal Butterworth cascade as blocked first-order complex scans.

Port of ``wav2vec_heart_sounds_tpu/ops/iir.py``. Each biquad is partial-fractioned on the
host in float64 into a direct term plus two first-order complex-pole recurrences

    H(w) = C + r1 / (1 - p1 w) + r2 / (1 - p2 w),      w = z^-1,

exactly as the JAX package does. Torch has no ``associative_scan``, and a per-sample loop
would launch hundreds of thousands of tiny kernels, so each recurrence
``y[n] = p*y[n-1] + r*x[n]`` runs in blocked form with two matrix products:

1. the signal is cut into chunks of ``L`` samples; inside a chunk (zero initial state)
   ``y_local = M x`` with the lower-triangular ``M[i, j] = r p^(i-j)``;
2. the true state at the end of each chunk obeys ``S[c] = p^L S[c-1] + y_local[c, L-1]``,
   a first-order recurrence over the ``T/L`` chunks, solved by the same kind of
   lower-triangular matrix ``Q[c, c'] = (p^L)^(c-c')``;
3. each chunk adds the carried-in state: ``y[c, i] += p^(i+1) S[c-1]``.

Every power is taken on the host in float64 as ``p^k`` directly (never as a ratio of
powers), and ``|p| < 1``, so every matrix entry is bounded and the float32 products are
stable. Complex numbers are carried as (re, im) float32 pairs; only ``Re(y)`` is needed
for a conjugate pair (output ``C x + 2 Re(y)``).

The design keeps the JAX package's fs-normalised cutoff convention: ``butter(order,
cutoff / fs)``, *not* ``cutoff / (fs / 2)``. The random parametric EQ of the on-device
augmentation (:mod:`..augment.torchaug`) designs its first-order band-pass sections on the
host too (:func:`butter1_bandpass_coeffs`, :func:`biquad_dynamic`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps

from . import full_fp32


@lru_cache(maxsize=None)
def design_butter(cutoff: float, fs: float, btype: str, order: int = 2):
    """Host-side Butterworth design with the paper's fs-normalised cutoff convention."""
    sos = sps.butter(order, cutoff / fs, btype=btype, output="sos")
    return tuple(tuple(float(v) for v in section) for section in np.asarray(sos))


@lru_cache(maxsize=None)
def _partial_fractions(section):
    """Split one normalised biquad into (C, p1, r1, p2, r2, conj_pair) in complex128.

    Returns None when the section is not a proper two-pole system.
    """
    b0, b1, b2, a0, a1, a2 = (np.float64(v) for v in section)
    if a0 != 1.0:
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    poles = np.roots([1.0, a1, a2]).astype(np.complex128)
    if len(poles) != 2 or a2 == 0.0:
        return None
    p1, p2 = poles
    if abs(p1 - p2) < 1e-9 * max(1.0, abs(p1)):
        return None  # defective (repeated pole): no clean partial fraction
    C = b2 / a2
    num = lambda w: b0 + b1 * w + b2 * w * w
    r1 = num(1.0 / p1) / (1.0 - p2 / p1)
    r2 = num(1.0 / p2) / (1.0 - p1 / p2)
    conj_pair = bool(abs(np.conj(p1) - p2) < 1e-9 * max(1.0, abs(p1)))
    return float(C.real), complex(p1), complex(r1), complex(p2), complex(r2), conj_pair


def block_len(T: int) -> int:
    """Chunk length ~sqrt(T) (a power of two, >= 64): balances the in-chunk ``T*L`` work
    against the ``(T/L)^2`` chunk-carry matrix."""
    return max(64, 1 << math.ceil(math.log2(max(1.0, math.sqrt(T)))))


@lru_cache(maxsize=64)
def _scan_matrices(p: complex, r: complex, L: int, n_chunks: int):
    """Float64 host matrices of the blocked scan (see the module docstring).

    ``W [L, L+1]``: columns 0..L-1 give ``Re(y_local)``, column L gives ``Im(y_local[L-1])``
    (the imaginary part of the chunk's end state). ``Q`` (re, im) ``[C, C]``: chunk-carry
    solve. ``P`` (re, im) ``[L]``: ``p^(i+1)``, the carried state's weight at offset i.
    """
    k = np.arange(L)
    diff = k[:, None] - k[None, :]                                   # i - j
    M = np.where(diff >= 0, r * np.power(p, np.maximum(diff, 0)), 0.0)   # [i, j]
    W = np.concatenate([M.real.T, M.imag[L - 1][:, None]], axis=1)   # x @ W
    c = np.arange(n_chunks)
    dc = c[:, None] - c[None, :]
    Q = np.where(dc >= 0, np.power(p, L * np.maximum(dc, 0)), 0.0)
    P = np.power(p, k + 1)
    return W, Q.real.T, Q.imag.T, P.real, P.imag


def first_order_scan_real(x: torch.Tensor, p: complex, r: complex) -> torch.Tensor:
    """``Re(y)`` of ``y[n] = p*y[n-1] + r*x[n]`` along the last axis of ``[R, T]``."""
    R, T = x.shape
    L = block_len(T)
    n_chunks = -(-T // L)
    xs = F.pad(x, (0, n_chunks * L - T)).reshape(R, n_chunks, L)     # causal: pad the end
    W, Qr, Qi, Pr, Pi = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                         for a in _scan_matrices(p, r, L, n_chunks))
    with full_fp32():
        local = xs @ W                                               # [R, C, L+1]
        y_re = local[..., :L]
        e_re, e_im = local[..., L - 1], local[..., L]                # chunk end states
        s_re = e_re @ Qr - e_im @ Qi                                 # [R, C] true states
        s_im = e_re @ Qi + e_im @ Qr
    s_re = F.pad(s_re[:, :-1], (1, 0))                               # state entering chunk c
    s_im = F.pad(s_im[:, :-1], (1, 0))
    y_re = y_re + s_re[..., None] * Pr - s_im[..., None] * Pi
    return y_re.reshape(R, n_chunks * L)[:, :T]


def _biquad(x: torch.Tensor, section, pf) -> torch.Tensor:
    """One section on ``[R, T]`` from its partial fractions ``pf``."""
    if pf is None:
        raise NotImplementedError(
            f"biquad {section} has a repeated pole; Butterworth sections never do")
    C, p1, r1, p2, r2, conj_pair = pf
    if conj_pair:
        return C * x + 2.0 * first_order_scan_real(x, p1, r1)
    return C * x + first_order_scan_real(x, p1, r1) + first_order_scan_real(x, p2, r2)


def sosfilt(x: torch.Tensor, sos) -> torch.Tensor:
    """Cascade of biquad sections along the last axis (zero initial conditions)."""
    lead, T = x.shape[:-1], x.shape[-1]
    y = x.reshape(-1, T)
    for section in sos:
        y = _biquad(y, section, _partial_fractions(section))
    return y.reshape(lead + (T,))


def lowpass(x: torch.Tensor, fs: float, cutoff: float, order: int = 2) -> torch.Tensor:
    return sosfilt(x, design_butter(cutoff, fs, "lowpass", order))


def highpass(x: torch.Tensor, fs: float, cutoff: float, order: int = 2) -> torch.Tensor:
    return sosfilt(x, design_butter(cutoff, fs, "highpass", order))


def bandpass_cascade(x: torch.Tensor, fs: float, low: float, high: float,
                     order: int = 2) -> torch.Tensor:
    """Causal LP at the high edge then HP at the low edge (the PCG/ECG preprocessing band)."""
    return highpass(lowpass(x, fs, high, order=order), fs, low, order=order)


def butter1_bandpass_coeffs(low: float, high: float) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """First-order Butterworth band-pass (scipy ``butter(1, [low, high], 'band')``) for
    Nyquist-normalised edges in (0, 1): the JAX package's closed-form bilinear transform of
    ``H(s) = Bw s / (s^2 + Bw s + Wo^2)`` at fs = 2, evaluated on the host in float64.
    Returns ``(b, a)`` with ``a[0] = 1``."""
    w1 = 4.0 * math.tan(math.pi * low / 2.0)
    w2 = 4.0 * math.tan(math.pi * high / 2.0)
    bw = w2 - w1
    wo2 = w1 * w2
    a0 = 16.0 + 4.0 * bw + wo2
    return ((4.0 * bw / a0, 0.0, -4.0 * bw / a0),
            (1.0, (2.0 * wo2 - 32.0) / a0, (16.0 - 4.0 * bw + wo2) / a0))


def biquad_dynamic(x: torch.Tensor, b, a) -> torch.Tensor:
    """One biquad with per-call coefficients ``b = (b0, b1, b2)``, ``a = (1, a1, a2)`` along
    the last axis (zero initial state), for the random parametric EQ. The JAX package
    traces the partial-fraction split inside jit; here the coefficients are host floats,
    so the split is the float64 host one of :func:`sosfilt` (not cached: every call draws
    new edges) and the recurrences run in the same blocked scan."""
    section = (float(b[0]), float(b[1]), float(b[2]), 1.0, float(a[1]), float(a[2]))
    lead, T = x.shape[:-1], x.shape[-1]
    y = _biquad(x.reshape(-1, T), section, _partial_fractions.__wrapped__(section))
    return y.reshape(lead + (T,))
