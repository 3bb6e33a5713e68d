"""CPU low-pass-filter profiler: worker-count sweep, int/float x 3x3/5x5.

The port's counterpart of the repository's tools/profile_cpu_filtering.py,
and the analog of the reference's `profileCpuFiltering` OpenMP baseline
(reference: main_aux_functions.h:2233-2396, enabled by the
PERFORM_CPU_FILTERING macro, main.cpp:11,395-406): it measures the host
CPU's filtering time as a function of thread count, as a baseline for
the card's filter stage (ops/filters.py).  The reference parallelizes
rows with `#pragma omp parallel for`; here each worker thread filters a
horizontal band (with halo rows) of the frame through the port's NumPy
golden filters (golden/filters_golden.py), and every band decomposition
is checked bit-equal to the whole-frame filter.

    python -m vvc_mip_gpu_tpu_torch.tools.profile_cpu_filtering \
        -s 1920x1080 --max-workers 16 --multiplier 4

``--multiplier`` repeats the work for stable timings (the reference's
MULTIPLIER_CPU_FILTER, main_aux_functions.h:7).  It measures the host by
design and runs without a card; its first line gives the host's CPU
count and the card's name and power limit, or says that none is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import time

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.bench import device_label
from vvc_mip_gpu_tpu_torch.golden import filters_golden as fg

VARIANTS = ("filterFrame_2d_int_quarterCtu",
            "filterFrame_2d_float_quarterCtu",
            "filterFrame_2d_int_5x5_quarterCtu",
            "filterFrame_2d_float_5x5_quarterCtu")


def filter_banded(frame: np.ndarray, filter_type: str, kernel_idx: int,
                  n_workers: int) -> np.ndarray:
    """Filter by horizontal bands, one per worker thread, each with
    ``radius`` halo rows of context per side: bit-identical to the
    whole-frame golden filter, since every output row sees the rows its
    taps reach."""
    h, _ = frame.shape
    if n_workers <= 1:
        return fg.filter_frame(frame, filter_type, kernel_idx)
    radius = 2 if "5x5" in filter_type else 1
    bounds = np.linspace(0, h, n_workers + 1, dtype=int)
    out = np.empty_like(frame)

    def work(i: int) -> None:
        y0, y1 = int(bounds[i]), int(bounds[i + 1])
        if y0 == y1:
            return
        lo = max(0, y0 - radius)
        hi = min(h, y1 + radius)
        band = fg.filter_frame(frame[lo:hi], filter_type, kernel_idx)
        out[y0:y1] = band[y0 - lo:y0 - lo + (y1 - y0)]

    with cf.ThreadPoolExecutor(n_workers) as ex:
        list(ex.map(work, range(n_workers)))
    return out


def host_cpus() -> int:
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def main(argv=None) -> dict[str, dict[int, float]]:
    """Print the sweep's table; returns {variant: {workers: ms}}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--resolution", default="1920x1080")
    p.add_argument("--max-workers", type=int, default=16)
    p.add_argument("--multiplier", type=int, default=1,
                   help="repeat count for stable timing")
    p.add_argument("--kernel-idx", type=int, default=0)
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.resolution.lower().split("x"))
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 1024, size=(h, w)).astype(np.int64)

    card = (device_label(torch.device("cuda", 0))
            if torch.cuda.is_available() else "no CUDA card present")
    print(f"host: {host_cpus()} CPUs; card: {card}")
    print(f"CPU filtering sweep {args.resolution}, "
          f"multiplier {args.multiplier}")
    counts = _worker_counts(args.max_workers)
    print(f"{'variant':<40s} " + " ".join(f"{n:>8d}w" for n in counts))
    table = {}
    for ft in VARIANTS:
        ref = fg.filter_frame(frame, ft, args.kernel_idx)
        table[ft] = {}
        for n in counts:
            t0 = time.perf_counter()
            for _ in range(args.multiplier):
                got = filter_banded(frame, ft, args.kernel_idx, n)
            ms = (time.perf_counter() - t0) / args.multiplier * 1e3
            if not np.array_equal(got, ref):
                raise RuntimeError(f"band seam mismatch: {ft}, {n} workers")
            table[ft][n] = ms
        print(f"{ft:<40s} " + " ".join(
            f"{ms:8.1f} " for ms in table[ft].values()))
    return table


def _worker_counts(max_workers: int) -> list[int]:
    n, out = 1, []
    while n <= max_workers:
        out.append(n)
        n *= 2
    return out


if __name__ == "__main__":
    main()
