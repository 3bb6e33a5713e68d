"""Stage timing and power-trace markers.

Mirrors the reference's two tracing mechanisms:
(1) per-stage accumulated timings printed as a compact report
    (reference: main_aux_functions.h:908-942), and
(2) TRACE_POWER wall-clock stage markers on stdout, machine-parsed by the
    energy harness (reference: main_aux_functions.h:180-211; consumed by
    computeEnergy_*.py:41-100).  Marker format: "<label>,<unix_time_float>".

On a CUDA device a stage ends by synchronizing the device's current
stream, so a stage's time covers the device work it enqueued, not only
the launches; a host-only stage (``sync=False``) does not wait, so it can
run on another thread while the device works.
"""

from __future__ import annotations

import collections
import time

import torch


def print_timestamp(label: str) -> None:
    """TRACE_POWER-style stage marker (reference: main_aux_functions.h:187)."""
    print(f"{label},{time.time():.6f}", flush=True)


class StageTimer:
    """Accumulates wall-clock time per named stage across frames.
    ``device``: where the stages' work runs; a CUDA device's current
    stream is synchronized at the end of every stage but a ``sync=False``
    one.  Stages may be timed from two threads (the CLI's writer)."""

    def __init__(self, trace_power: bool = False, device=None):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.trace_power = trace_power
        self.device = None if device is None else torch.device(device)
        self._t0 = time.perf_counter()

    class _Ctx:
        def __init__(self, timer: "StageTimer", stage: str, sync: bool):
            self.timer = timer
            self.stage = stage
            self.sync = sync

        def __enter__(self):
            if self.timer.trace_power:
                print_timestamp(f"START {self.stage}")
            self.start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dev = self.timer.device
            if self.sync and dev is not None and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            dt = time.perf_counter() - self.start
            self.timer.totals[self.stage] += dt
            self.timer.counts[self.stage] += 1
            if self.timer.trace_power:
                print_timestamp(f"FINISH {self.stage}")
            return False

    def stage(self, name: str, sync: bool = True) -> "_Ctx":
        return self._Ctx(self, name, sync)

    def report(self) -> str:
        """Full per-stage report (analog of reportTimingResults)."""
        lines = ["Stage timing report:"]
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(
                f"  {name:<28s} total {total * 1e3:10.3f} ms"
                f"  x{n}  avg {total / n * 1e3:10.3f} ms")
        return "\n".join(lines)

    def report_compact(self, n_frames: int) -> str:
        """Analog of reportTimingResults_Compact (total elapsed; FPS)."""
        elapsed = time.perf_counter() - self._t0
        return (f"TotalElapsedMs,{elapsed * 1e3:.2f},frames,{n_frames},"
                f"fps,{n_frames / elapsed:.3f}")
