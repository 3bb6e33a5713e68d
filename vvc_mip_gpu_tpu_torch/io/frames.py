"""Synthetic frames for tests and the GPU smoke run."""

from __future__ import annotations

import numpy as np


def synthetic_frames(n_frames: int, width: int, height: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-video: smooth gradients plus moving texture,
    quantized to 10 bits (more representative of video statistics than
    white noise).  Returns [n_frames, height, width] uint16."""
    rng = np.random.default_rng(seed)
    y = np.arange(height)[:, None]
    x = np.arange(width)[None, :]
    base = rng.integers(0, 1024, size=(height, width))
    out = np.empty((n_frames, height, width), np.uint16)
    for f in range(n_frames):
        grad = (512 + 300 * np.sin(2 * np.pi * (x + 7 * f) / 256)
                * np.cos(2 * np.pi * (y - 3 * f) / 192))
        mix = 0.7 * grad + 0.3 * np.roll(base, (f * 2, f * 3), (0, 1))
        out[f] = np.clip(mix, 0, 1023).astype(np.uint16)
    return out
