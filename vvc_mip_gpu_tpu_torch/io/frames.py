"""Frame ingest: the reference's CSV-of-luma-samples format, and synthetic
frames for tests and the GPU smoke run.

Format (reference: main.cpp:318-387): a text file where each line holds one
pixel row of comma-separated 10-bit luma samples; frames are concatenated
vertically (frame f occupies lines [f*H, (f+1)*H)).  Read and written with
numpy alone.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np


def read_frames_csv(path: str | Path, width: int, height: int,
                    n_frames: int, start: int = 0) -> np.ndarray:
    """Read [n_frames, height, width] uint16 samples, skipping the first
    ``start`` frames."""
    rows = height * n_frames
    with open(path, "rb") as f:
        lines = list(itertools.islice(f, start * height,
                                      start * height + rows))
    text = b",".join(line.rstrip(b"\r\n") for line in lines)
    data = (np.fromstring(text, dtype=np.int64, sep=",") if text
            else np.empty(0, np.int64))
    if (len(lines) != rows or data.size != rows * width
            or any(line.count(b",") != width - 1 for line in lines)):
        raise ValueError(
            f"{path}: got {len(lines)} rows and {data.size} samples from "
            f"frame {start}, expected {rows} rows of {width}")
    if data.size and (data.min() < 0 or data.max() > np.iinfo(np.uint16).max):
        raise ValueError(f"{path}: samples outside 0..65535")
    return data.astype(np.uint16).reshape(n_frames, height, width)


def write_frames_csv(path: str | Path, frames: np.ndarray) -> None:
    """Write frames in the reference CSV format (filtered-frame export,
    reference main.cpp:789-817): one pixel row per line."""
    frames = np.asarray(frames)
    flat = frames.reshape(-1, frames.shape[-1]).astype(np.int64)
    np.savetxt(path, flat, fmt="%d", delimiter=",")


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
