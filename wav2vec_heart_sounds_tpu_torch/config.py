"""Host constants of the scoring path, copied from the JAX package.

The JAX package's own modules cannot be imported here (its package ``__init__``s pull in
jax, flax and pandas), so the constants are copied with their source cited;
``tests/test_torch_imports.py`` checks each one against the original.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WindowSpec:
    """Segmentation window (copy of ``wav2vec_heart_sounds_tpu/signal/segment.py:15-28``)."""
    window_s: float
    overlap_s: float = 0.25
    start_pad_s: float = 0.3

    def window_len(self, fs: float) -> int:
        return int(round(self.window_s * fs))

    def hop_len(self, fs: float) -> int:
        return max(1, int(round((self.window_s - self.overlap_s) * fs)))

    def start_offset(self, fs: float) -> int:
        return int(round(self.start_pad_s * fs))


# Classification sample rates (wav2vec_heart_sounds_tpu/config.py:13-14).
CLASSIFY_FS_CINC = 16000
CLASSIFY_FS_DEFAULT = 4125

# Per-dataset segmentation windows (wav2vec_heart_sounds_tpu/config.py:21-25).
WINDOWS = {
    "cinc": WindowSpec(window_s=4.0),
    "training-a": WindowSpec(window_s=4.0),
    "vest": WindowSpec(window_s=2.0),
}


def default_window(dataset: str) -> WindowSpec:
    """A dataset's window, 4 s where none is set (wav2vec_heart_sounds_tpu/config.py:28-29)."""
    return WINDOWS.get(dataset, WindowSpec(window_s=4.0))

# Causal preprocessing bands in Hz (wav2vec_heart_sounds_tpu/signal/filters.py:18-19).
PCG_BAND = (25.0, 450.0)
ECG_BAND = (2.0, 40.0)

# int16 wire format for [-1, 1] waveforms (wav2vec_heart_sounds_tpu/data/loader.py:35).
WIRE_SCALE = 32767.0
