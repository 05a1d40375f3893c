"""Cardiac-cycle rearrangement for generator training.

Per-record segmentation JSONs (``{"segments": [[index, …], …], "fs": int}``) mark cycle join
points. For diffusion-target diversification, a signal is cut at the joins, the cycles are
re-ordered (a contiguous rotation, or a shuffle of small groups), and the sequence is rebuilt
to a target length with a correlation-aware crossfade at every seam. Reference/conditioning
signals must stay aligned, so re-ordering is expressed as a single index permutation
(:func:`cycle_order`) applied to every signal.

Behavioral semantics follow reference src/mpcg_wav2vec/datasets/heart_cycles.py:22-95 (the
skewed-sine + even-power fade is the paper's seam formula); the implementation differs:
ordering is a pure permutation function, and :func:`rebuild` writes seams into one
preallocated buffer instead of repeatedly concatenating (O(total) instead of O(total^2)).

A copy of ``wav2vec_heart_sounds_tpu/data/heart_cycles.py``, held to the original by
``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np


def load_join_indices(seg_path: str | Path, fs_out: float) -> list[int]:
    """Sorted positive cycle cut points, rescaled to ``fs_out`` samples."""
    meta = json.loads(Path(seg_path).read_text())
    starts = np.asarray([g[0] for g in meta["segments"] if len(g)], dtype=np.int64)
    starts = np.unique(starts[starts > 0])
    scale = fs_out / meta["fs"]
    if scale != 1.0:
        starts = np.round(starts * scale).astype(np.int64)
    return starts.tolist()


def split_cycles(signal: np.ndarray, joins: list[int]) -> list[np.ndarray]:
    """Cut ``signal`` at in-range join points; one array per complete cycle between joins."""
    cuts = np.asarray([j for j in joins if 0 < j < len(signal)], dtype=np.int64)
    if len(cuts) < 2:
        return []
    pieces = np.split(signal[cuts[0]:cuts[-1]], cuts[1:-1] - cuts[0])
    return [p for p in pieces if len(p)]


def _fade_curve(tail: np.ndarray, head: np.ndarray) -> np.ndarray:
    """Fade-in gain over the seam; shape depends on how correlated the two sides are."""
    n = len(tail)
    if min(np.var(tail), np.var(head)) < 1e-5:
        return np.linspace(0.0, 1.0, n)
    r = np.corrcoef(tail, head)[0, 1]
    r = 0.0 if np.isnan(r) else abs(r)
    t = np.linspace(-1.0, 1.0, n)
    skew = (9 / 16) * np.sin(np.pi / 2 * t) + (1 / 16) * np.sin(3 * np.pi / 2 * t)
    even = np.sqrt(np.clip(0.5 / (1 + r) - ((1 - r) / (1 + r)) * skew ** 2, 0.0, None))
    return np.clip(even + skew, 0.0, 1.0)


def crossfade(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Join two cycles with an ``n``-sample correlation-aware seam."""
    if n <= 1 or len(a) < n or len(b) < n:
        return np.concatenate([a, b])
    gain = _fade_curve(a[-n:], b[:n])
    seam = a[-n:] * (1.0 - gain) + b[:n] * gain
    return np.concatenate([a[:-n], seam, b[n:]])


def rebuild(cycles: list[np.ndarray], target_len: int, fade_samples: int) -> np.ndarray:
    """Seam-join cycles (looping the list as needed) to at least ``target_len`` samples.

    Single preallocated output buffer; each seam only rewrites the last ``fade_samples``
    positions, so total work is linear in the output length. A guard bounds the loop for
    degenerate inputs (all-too-short cycles), mirroring the defensive-skip policy.
    """
    if not cycles:
        return np.zeros(target_len)
    longest = max(len(c) for c in cycles)
    buf = np.empty(target_len + longest + fade_samples, dtype=np.float64)
    pos = len(cycles[0])
    buf[:pos] = cycles[0]

    i, guard = 1, 10 * len(cycles) + 4
    while pos < target_len and guard:
        c = cycles[i % len(cycles)]
        n = fade_samples
        if n > 1 and pos >= n and len(c) >= n:
            gain = _fade_curve(buf[pos - n:pos], c[:n])
            buf[pos - n:pos] = buf[pos - n:pos] * (1.0 - gain) + c[:n] * gain
            buf[pos:pos + len(c) - n] = c[n:]
            pos += len(c) - n
        else:
            buf[pos:pos + len(c)] = c
            pos += len(c)
        i += 1
        guard -= 1
    return buf[:pos].copy()


def cycle_order(num: int, rng: random.Random, *, prob_contiguous: float = 0.0,
                random_start: bool = True) -> list[int]:
    """A permutation of ``range(num)``: contiguous rotation, or small-group shuffle.

    With probability ``prob_contiguous`` the order is a rotation (optionally from a random
    start); otherwise the cycles are chunked into groups — all singletons, or (50/50) a
    repeating pattern of five random sizes in 1..4 — and the groups are shuffled.
    """
    if rng.random() <= prob_contiguous:
        start = rng.randint(0, num - 1) if random_start else 0
        return [(start + i) % num for i in range(num)]

    if rng.random() < 0.5:
        sizes = [1]
    else:
        sizes = [rng.randint(1, 4) for _ in range(5)]
    bounds, i, s = [0], 0, 0
    while bounds[-1] < num:
        bounds.append(min(num, bounds[-1] + sizes[s % len(sizes)]))
        s += 1
    groups = [list(range(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]
    rng.shuffle(groups)
    return [i for g in groups for i in g]


def rearrange(cycles_by_signal: dict[str, list[np.ndarray]], *, prob_contiguous: float = 0.0,
              random_start: bool = True,
              rng: random.Random | None = None) -> dict[str, list[np.ndarray]]:
    """Re-order cycles with one shared permutation so all signals stay aligned."""
    rng = rng or random.Random()
    num = min((len(v) for v in cycles_by_signal.values()), default=0)
    if num < 2:
        return cycles_by_signal
    order = cycle_order(num, rng, prob_contiguous=prob_contiguous, random_start=random_start)
    return {name: [cycles[i] for i in order] for name, cycles in cycles_by_signal.items()}
