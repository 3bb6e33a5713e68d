"""Stage timing, power-trace markers and the port's spans.

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

(3) Spans inside the port (``span``), recorded only while a torch
profiler records in the process.  A span is then a range named
``vvc_mip.<name>`` in the profile, on the clock of the device
operations, and a record here: host nanoseconds and, where the caller
names a CUDA device, a pair of CUDA events on its current stream.  With
no profiler recording a span is one flag check and a shared no-op
context.  The records are read with ``spans``, ``host_ms`` and
``device_ms``, and forgotten with ``clear``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# spans kept in memory; later ones are counted in ``dropped()`` instead
MAX_SPANS = 100_000


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    events: tuple | None  # (start, end) CUDA events, or None


class _Store:
    def __init__(self):
        # plain tuples, made Spans when read: cheaper to record
        self.spans: list[tuple] = []
        self.dropped = 0
        self.lock = threading.Lock()


_store = _Store()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "range", "start", "t0")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self):
        # the profiler's light range (as torch's own compiled code uses):
        # 1-2 us under a profiler on an H100 machine's host, where
        # ``record_function`` takes ~10 us and slows the launches inside
        # it; it shows as an operator, not a user annotation
        self.range = torch._C._profiler._RecordFunctionFast(
            "vvc_mip." + self.name)
        self.range.__enter__()
        self.start = None
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start, end)
        self.range.__exit__(*exc)
        record = (self.name, self.t0, t1, events)
        with _store.lock:
            if len(_store.spans) < MAX_SPANS:
                _store.spans.append(record)
            else:
                _store.dropped += 1
        return False


def span(name: str, device: torch.device | None = None):
    """Context manager: the block as span ``name`` while a profiler
    records (the profiler's process-wide flag: its C-level flag is per
    thread), else nothing.  ``device``: a CUDA device whose current
    stream the span also times, with a pair of CUDA events (~30 us of
    host time on an H100's host: pass it only where the device time is
    read)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spans(name: str | None = None) -> list[Span]:
    """The kept records, oldest end first; only ``name``'s if given."""
    return [Span(*s) for s in _store.spans if name is None or s[0] == name]


def host_ms(name: str, since_ns: int = 0) -> list[float]:
    """Host milliseconds of each kept span ``name`` that started at
    ``since_ns`` or later."""
    return [(s.end_ns - s.start_ns) * 1e-6 for s in spans(name)
            if s.start_ns >= since_ns]


def device_ms(name: str, since_ns: int = 0) -> list[float]:
    """Device milliseconds of each kept span ``name`` that timed a CUDA
    stream and started at ``since_ns`` or later; call once the device
    has finished them."""
    return [s.events[0].elapsed_time(s.events[1]) for s in spans(name)
            if s.events is not None and s.start_ns >= since_ns]


def dropped() -> int:
    """Spans not kept since the store was full."""
    return _store.dropped


def clear() -> None:
    """Forget every span."""
    with _store.lock:
        _store.spans.clear()
        _store.dropped = 0


def print_timestamp(label: str) -> None:
    """TRACE_POWER-style stage marker (reference: main_aux_functions.h:187)."""
    print(f"{label},{time.time():.6f}", flush=True)


class StageTimer:
    """Accumulates wall-clock time per named stage across frames.
    ``device``: where the stages' work runs; a CUDA device's current
    stream is synchronized at the end of every stage but a ``sync=False``
    one.  Stages may be timed from two threads (the CLI's writer).  Each
    stage is also the span ``stage.<name>``, its sync included."""

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
            self.span = span("stage." + self.stage)
            self.span.__enter__()
            self.start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dev = self.timer.device
            if self.sync and dev is not None and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            dt = time.perf_counter() - self.start
            self.timer.totals[self.stage] += dt
            self.timer.counts[self.stage] += 1
            self.span.__exit__(*exc)
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
