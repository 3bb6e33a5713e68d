"""Frame ingest: the reference's CSV-of-luma-samples format, and synthetic
frames for tests and the GPU smoke run.

Format (reference: main.cpp:318-387): a text file where each line holds one
pixel row of comma-separated 10-bit luma samples; frames are concatenated
vertically (frame f occupies lines [f*H, (f+1)*H)).  Read and written
through the C reader and writer of ``csrc/io_native.c``
(``io/native.py``); the ``*_plain`` versions, in numpy, are their oracle
and define what the C reader accepts and the errors it raises.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np

from vvc_mip_gpu_tpu_torch.io import native


def _shape_error(path, n_lines: int, n_samples: int, start: int, rows: int,
                 width: int) -> ValueError:
    return ValueError(
        f"{path}: got {n_lines} rows and {n_samples} samples from "
        f"frame {start}, expected {rows} rows of {width}")


def _range_error(path) -> ValueError:
    return ValueError(f"{path}: samples outside 0..65535")


def read_frames_csv(path: str | Path, width: int, height: int,
                    n_frames: int, start: int = 0) -> np.ndarray:
    """Read [n_frames, height, width] uint16 samples, skipping the first
    ``start`` frames, through the C reader: it parses as
    ``read_frames_csv_plain`` does and raises the same ValueError in the
    same cases (a wrong row, sample or comma count; a sample outside
    0..65535)."""
    rows = height * n_frames
    data, (n_lines, n_samples, commas_ok, in_range) = native.read_samples_csv(
        path, width, rows, start * height)
    if n_lines != rows or n_samples != rows * width or not commas_ok:
        raise _shape_error(path, n_lines, n_samples, start, rows, width)
    if n_samples and not in_range:
        raise _range_error(path)
    return data.reshape(n_frames, height, width)


def read_frames_csv_plain(path: str | Path, width: int, height: int,
                          n_frames: int, start: int = 0) -> np.ndarray:
    """``read_frames_csv`` in numpy: the C reader's oracle."""
    rows = height * n_frames
    with open(path, "rb") as f:
        lines = list(itertools.islice(f, start * height,
                                      start * height + rows))
    text = b",".join(line.rstrip(b"\r\n") for line in lines)
    data = (np.fromstring(text, dtype=np.int64, sep=",") if text
            else np.empty(0, np.int64))
    if (len(lines) != rows or data.size != rows * width
            or any(line.count(b",") != width - 1 for line in lines)):
        raise _shape_error(path, len(lines), data.size, start, rows, width)
    if data.size and (data.min() < 0 or data.max() > np.iinfo(np.uint16).max):
        raise _range_error(path)
    return data.astype(np.uint16).reshape(n_frames, height, width)


def write_frames_csv(path: str | Path, frames: np.ndarray) -> None:
    """Write frames in the reference CSV format (filtered-frame export,
    reference main.cpp:789-817): one pixel row per line, through the C
    writer (the bytes of ``write_frames_csv_plain``)."""
    frames = np.asarray(frames)
    native.write_samples_csv(path, frames.reshape(-1, frames.shape[-1]))


def write_frames_csv_plain(path: str | Path, frames: np.ndarray) -> None:
    """``write_frames_csv`` in numpy: the C writer's oracle."""
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
