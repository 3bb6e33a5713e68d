"""Device meshes for the sharded MIP engine, and the stream rule.

The reference engine is single-process, single-GPU (SURVEY.md §2.2); the
scaling axes are the two embarrassingly- / nearly-embarrassingly-parallel
dimensions of the workload:

* ``data``  — whole frames (pure data parallelism; the analog of the
  reference's per-frame loop with BUFFER_SLOTS prefetch, main.cpp:678-1241).
* ``space`` — contiguous CTU-row bands within a frame.  Needs a one-row halo
  of reference samples at band boundaries, because boundary extraction
  reads the row directly above each CTU (reference: intra.cl:76).

A mesh is a numpy object array ``[n_data, n_space]`` of ``torch.device``s.
A device may appear more than once (several shards on one card, or the
CPU standing in for several devices); the engines then run each shard on a
CUDA stream of its own (``shard_stream``), so shards that share a card run
concurrently and in order with the default stream only where they meet
it: ``fork`` before a side stream reads what the default stream wrote,
``join`` before the default stream reads what a side stream wrote.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; empty when there is none (never the
    CPU)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int, n_space: int, devices=None) -> np.ndarray:
    """A (data, space) grid over the given devices (default: every visible
    CUDA device), in row-major order.  ``devices`` may repeat a device."""
    if devices is None:
        devices = visible_devices()
    n = n_data * n_space
    if n < 1:
        raise ValueError(f"mesh {n_data}x{n_space} is empty")
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return grid.reshape(n_data, n_space)


def factor_devices(n_devices: int, n_frames: int | None = None
                   ) -> tuple[int, int]:
    """Pick a (data, space) factorization.

    Frames are embarrassingly parallel while spatial sharding pays a halo
    exchange plus padded-CTU-row overhead, so the throughput default is
    PURE frame parallelism (space=1).  Spatial sharding is engaged only
    when there are fewer frames than devices (latency mode: a single
    frame still uses every chip).
    """
    if n_frames is None or n_frames >= n_devices:
        return n_devices, 1
    n_frames = max(n_frames, 1)
    # Smallest space shard count that keeps every chip busy.
    for space in range(1, n_devices + 1):
        if n_devices % space == 0 and n_devices // space <= n_frames:
            return n_devices // space, space
    return n_devices, 1


def shard_stream(device: torch.device):
    """A CUDA stream of its own on ``device``; None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Make ``stream`` current (on its device) inside the block."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def fork(stream, *inputs: torch.Tensor) -> None:
    """Order ``stream`` after the work its device's current stream has
    queued (the uploads of ``inputs``), and keep the allocator from
    reusing ``inputs``' memory before ``stream`` is done with it."""
    if stream is None:
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in inputs:
        t.record_stream(stream)


def join(stream, *outputs: torch.Tensor) -> None:
    """Order the current stream of ``stream``'s device after ``stream``'s
    work, and mark ``outputs`` (written on ``stream``) as in use there."""
    if stream is None:
        return
    current = torch.cuda.current_stream(stream.device)
    current.wait_stream(stream)
    for t in outputs:
        t.record_stream(current)
