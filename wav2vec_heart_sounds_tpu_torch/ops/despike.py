"""Batched Schmidt spike removal (port of ``wav2vec_heart_sounds_tpu/ops/despike.py``).

Each iteration finds, for every row at once, the worst 500 ms window (largest
max-abs-amplitude), the spike peak in it and the zero crossings around the peak, and
flattens that span to ``SPIKE_FLOOR`` in rows that are still active. A row is active while
some window's MAA exceeds ``threshold`` x the row's median MAA. The loop is a Python loop
with one host sync per iteration; clean signals exit after the first test.

The loop also stops at a fixed point. When the sign flips right after a spike's peak, the
flattened span ``[start, end)`` leaves the peak out, so the row stays active and every
later iteration changes nothing; the JAX ``while_loop`` then spins to ``max_iterations``
on the device. The loop's only state is ``frames``, so once an iteration changes no
sample, the output is already the one ``max_iterations`` iterations would give, and the
port stops instead of paying ~1000 host round trips.

The median is the mean of the two middle values for an even window count, as
``jnp.median``: ``torch.median`` returns the lower middle value instead, which would move
the threshold (64000 samples at 16 kHz make 8 half-second windows, an even count).
"""

from __future__ import annotations

import torch

SPIKE_FLOOR = 1e-4


def median_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=-1, keepdims=True)``: midpoint of the two middle values."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    lo = s[..., (n - 1) // 2:(n - 1) // 2 + 1]
    hi = s[..., n // 2:n // 2 + 1]
    return (lo + hi) / 2


def remove_spikes(x: torch.Tensor, fs: float, threshold: float = 3.0,
                  max_iterations: int = 1000) -> torch.Tensor:
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    B, T = x.shape
    win = round(float(fs) / 2.0)
    if win < 1 or T < win:
        return x[0] if squeeze else x

    usable = T - T % win
    frames = x[:, :usable].reshape(B, -1, win).clone()
    rows = torch.arange(B, device=x.device)
    pos = torch.arange(win, device=x.device)
    flip_pos = torch.arange(win - 1, device=x.device)

    def active_rows():
        maa = frames.abs().amax(dim=2)                                   # [B, W]
        return (maa > threshold * median_last(maa)).any(dim=1), maa      # [B], [B, W]

    active, maa = active_rows()
    go = bool(active.any())
    it = 0
    while go and it < max_iterations:
        worst = maa.argmax(dim=1)                                        # [B]
        window = frames[rows, worst]                                     # [B, win]
        peak = window.abs().argmax(dim=1)                                # [B]

        signs = torch.sign(window)
        flips = (signs[:, 1:] - signs[:, :-1]).abs() > 1                 # [B, win-1]
        before = flips & (flip_pos[None, :] < peak[:, None])
        after = flips & (flip_pos[None, :] >= peak[:, None])
        start = torch.where(before, flip_pos[None, :], -1).amax(dim=1) + 1
        end = torch.where(after, flip_pos[None, :], win - 1).amin(dim=1)

        span = (pos[None, :] >= start[:, None]) & (pos[None, :] < end[:, None])
        hit = span & active[:, None]
        changed = (hit & (window != SPIKE_FLOOR)).any()
        frames[rows, worst] = torch.where(hit, torch.full_like(window, SPIKE_FLOOR), window)
        active, maa = active_rows()
        it += 1
        go = bool(changed & active.any())                                # the one host sync

    out = x.clone()
    out[:, :usable] = frames.reshape(B, usable)
    return out[0] if squeeze else out
