"""In-context per-class cost attribution of the port's 1080p search.

The port's counterpart of the repository's tools/profile_incontext.py.
Each shape class is timed through the engine's own path,
``_run_classes(frame, frame, frame[:, 0], True, W, H, True,
classes=(i,))`` (models/cost_engine.py), so a class's number holds what
the whole search pays for it: the frame's int16 conversion, the
output's allocation (a hit of the caching allocator, no fill) and the
class's one kernel launch.  The sum over the
classes counts those shared steps 17 times; the leave-one-out deltas
(e2e minus the search without one class) count them once.

    python -m vvc_mip_gpu_tpu_torch.tools.profile_incontext
        # e2e, each class alone, the sum of the classes
    python -m vvc_mip_gpu_tpu_torch.tools.profile_incontext --loo
        # the same, then each class left out, with its delta
    python -m vvc_mip_gpu_tpu_torch.tools.profile_incontext --batch N
        [--class WxH]
        # N frames in one search: ms per batch and per frame (one class)
    python -m vvc_mip_gpu_tpu_torch.tools.profile_incontext --batch N --loo
        # the --loo sweep on N frames
    python -m vvc_mip_gpu_tpu_torch.tools.profile_incontext --class WxH
        # one class alone on the one frame

The search runs on one 1920x1080 frame (N frames with ``--batch``) drawn
from ``default_rng(0)``.  On one frame a class alone is shorter on the
card than the host's call of ``_run_classes``, so its line times the
host; ``--batch N --loo`` (not in the JAX tool, whose timing loop runs
inside one compiled program) gives the sweep at a batch that keeps the
card busy.  A time is the median over ``REPEATS`` runs of ``ITERS``
calls each, by CUDA events, after ``ITERS`` + 1 untimed calls; every
line gives the launches
of each cost kernel per call (``CostKernel.launches``) and the device
(the card's name and power limit).  It runs on the CUDA card, or on the
CPU through the kernels' plain versions with VVC_MIP_PLATFORM=cpu (host
clock; launches 0); with neither it raises, as the CLI does.  The JAX
tool's ``--ablate`` has no counterpart (see ``ABLATE``).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.bench import device_label
from vvc_mip_gpu_tpu_torch.cli import local_devices
from vvc_mip_gpu_tpu_torch.models.cost_engine import _run_classes
from vvc_mip_gpu_tpu_torch.ops.geometry import class_plans
from vvc_mip_gpu_tpu_torch.ops.mip_cost import KERNELS

WIDTH, HEIGHT = 1920, 1080
REPEATS = 5
ITERS = 10
ABLATE = ("--ablate has no counterpart in the port: the JAX tool replaces "
          "the gathers and phase splits it runs as passes of their own, "
          "and in the port their roles sit inside the cost kernels' load "
          "stages")


def blocks_of(frames: torch.Tensor, classes=None) -> torch.Tensor:
    """The whole minSadHad output, [B, nCTU, 97840], of ``classes`` (all
    by default) over [B, H, W] frames, original samples, max-performance:
    only the classes' ``_columns`` are written.  (It once returned the
    classes' per-group views of that output; the unit of work timed is
    the same.)"""
    _, h, w = frames.shape
    return _run_classes(frames, frames, frames[:, 0], True, w, h, True,
                        classes)[0]


def timed(fn, device: torch.device, repeats: int,
          iters: int) -> tuple[float, list[int]]:
    """(median ms of one call of ``fn``, each cost kernel's launches in
    one call).  The launches are counted over the first of the ``iters``
    + 1 untimed warm-up calls."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    for k in KERNELS:
        k.launches = 0
    fn()
    sync()
    launches = [k.launches for k in KERNELS]
    for _ in range(iters):
        fn()
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times), launches


def profile(width: int, height: int, device: torch.device, *,
            loo: bool = False, batch: int | None = None,
            only: str | None = None, repeats: int = REPEATS,
            iters: int = ITERS) -> list[dict]:
    """Print one line per measurement and return them as records
    {"what", "class", "frames", "ms", "ms_per_frame", "launches",
    "device"}: "e2e", then "alone" per class, "sum" and, with ``loo``,
    "without" per class (with "delta_ms"), on one frame or ``batch``
    frames; with ``batch`` but not ``loo``, only the "e2e"; with ``only``
    ("WxH"), that class alone."""
    label = device_label(device)
    plans = class_plans(width, height)
    names = [f"{cp.shape.width}x{cp.shape.height}" for cp in plans]
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 1024, size=(1, height, width), dtype=np.int32)
    if batch:
        frames = rng.integers(0, 1024, size=(batch, height, width),
                              dtype=np.int32)
    frames = torch.from_numpy(frames).to(device)
    n = frames.shape[0]
    records = []

    def measure(what: str, name: str | None, classes, text) -> float:
        """Time ``classes``; print ``text(ms)`` and the launches per
        call."""
        ms, launches = timed(lambda: blocks_of(frames, classes), device,
                             repeats, iters)
        records.append({"what": what, "class": name, "frames": n, "ms": ms,
                        "ms_per_frame": ms / n, "launches": launches,
                        "device": label})
        print(f"{text(ms)}; launches {launches} ({label})", flush=True)
        return ms

    if only is not None:
        if only not in names:
            raise ValueError(f"no class {only!r}; classes: {names}")
        measure("alone", only, (names.index(only),),
                lambda ms: f"only class {only}, {n} frame(s): {ms:8.4f} ms "
                           f"= {ms / n:.4f} ms/frame")
        return records
    if batch and not loo:
        measure("e2e", None, None,
                lambda ms: f"e2e batch {n} (max-perf): {ms:8.4f} ms = "
                           f"{ms / n:.4f} ms/frame")
        return records

    e2e = measure("e2e", None, None,
                  lambda ms: f"e2e (max-perf), {n} frame(s): {ms:8.4f} ms")
    total = 0.0
    for i, (cp, name) in enumerate(zip(plans, names)):
        total += measure(
            "alone", name, (i,),
            lambda ms: f"  only class {i:2d} {name:>5s} sid"
                       f"{cp.shape.size_id}: {ms:8.4f} ms")
    records.append({"what": "sum", "class": None, "frames": n, "ms": total,
                    "ms_per_frame": total / n, "launches": None,
                    "device": label})
    print(f"sum(only-class): {total:8.4f} ms (vs e2e {e2e:.4f}; excess = "
          f"the frame's conversion, the output's allocation and a call, "
          f"each counted {len(plans)}x) ({label})", flush=True)
    if loo:
        for i, (cp, name) in enumerate(zip(plans, names)):
            rest = tuple(j for j in range(len(plans)) if j != i)
            measure("without", name, rest,
                    lambda ms: f"  without class {i:2d} {name:>5s} sid"
                               f"{cp.shape.size_id}: {ms:8.4f} ms (delta "
                               f"{e2e - ms:+8.4f})")
            records[-1]["delta_ms"] = e2e - records[-1]["ms"]
    return records


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--loo", action="store_true",
                   help="also leave each class out, with its delta (on "
                        "--batch frames when given)")
    p.add_argument("--batch", type=int, default=None,
                   help="search N frames at once")
    p.add_argument("--class", dest="only", default=None, metavar="WxH",
                   help="time this class alone")
    p.add_argument("--ablate", action="store_true", help=ABLATE)
    args = p.parse_args(argv)
    if args.ablate:
        p.error(ABLATE)
    device = local_devices(1)[0]  # raises without a card, as the CLI does
    return profile(WIDTH, HEIGHT, device, loo=args.loo, batch=args.batch,
                   only=args.only)


if __name__ == "__main__":
    main()
