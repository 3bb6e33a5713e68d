"""What a run records for the per-layer metrics, and the reading of the
device trace.

A ``Trace`` holds host spans (host clock, every span of the window), device
spans (a pair of CUDA events around the call, so the time the card spent
from the first to the last of the call's work), counters, and, in a traced
run, a ``torch.profiler`` trace over a steady stretch of the window.  With
tracing off a span costs two clock reads and nothing else.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import statistics
import time

import torch

STRETCH_NAME = "portbench.stretch"


class Trace:
    def __init__(self, cell, enabled: bool, device):
        self.cell = cell  # harness.Cell: its config and traffic
        self.entry = cell.traffic["entry"]  # which loop ran
        self.enabled = enabled
        self.device = torch.device(device)
        self.host = collections.defaultdict(list)  # name -> [seconds]
        self._events = collections.defaultdict(list)  # name -> [(ev, ev)]
        self.counters = collections.Counter()
        self.profile: dict | None = None  # set by read_profile()
        self._prof = None
        self._stretch = None
        self._marks: dict[str, int] = {}  # device spans before the stretch
        self.stretch_spans: dict[str, range] = {}  # device spans in it

    def reset(self) -> None:
        """Forget what the warm-up recorded."""
        self.host.clear()
        self._events.clear()
        self.counters.clear()
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        """Host clock around the block, always; with tracing on also a
        profiler range and, with ``device``, a CUDA event pair."""
        if not self.enabled:
            t = time.perf_counter()
            yield
            self.host[name].append(time.perf_counter() - t)
            return
        cuda = device and self.device.type == "cuda"
        with torch.profiler.record_function("portbench." + name):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t = time.perf_counter()
            yield
            self.host[name].append(time.perf_counter() - t)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._events[name].append((start, end))

    def host_ms(self, name: str) -> list[float]:
        return [s * 1e3 for s in self.host.get(name, ())]

    def device_ms(self, name: str) -> list[float]:
        """Milliseconds between each event pair of ``name`` (call after
        the device has finished)."""
        return [a.elapsed_time(b) for a, b in self._events.get(name, ())]

    def start_profile(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        self._stretch = torch.profiler.record_function(STRETCH_NAME)
        self._stretch.__enter__()
        self._marks = {k: len(v) for k, v in self._events.items()}

    def stop_profile(self) -> None:
        self._stretch.__exit__(None, None, None)
        self._prof.stop()
        self.stretch_spans = {k: range(self._marks.get(k, 0), len(v))
                              for k, v in self._events.items()}

    def read_profile(self) -> None:
        """Read the stretch's trace (after the window: it is slow) into
        ``profile``, with the device spans' own sum over the stretch
        beside the profiler's busy time."""
        if self._prof is None:
            return
        self.profile = read_profile(_intervals(self._prof.events()))
        self._prof = None
        if self.profile:
            self.profile["event_busy_s"] = sum(
                self._events[k][i][0].elapsed_time(self._events[k][i][1])
                for k, r in self.stretch_spans.items() for i in r) * 1e-3


def _intervals(events):
    """(name, start us, end us, an operation on the device) of each
    profiled event; the device's copies of the host's annotations (the
    harness's spans) are left out."""
    out = []
    for e in events:
        on_device = e.device_type != torch.autograd.DeviceType.CPU
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name.startswith("portbench.")):
            continue
        out.append((e.name, e.time_range.start, e.time_range.end, on_device))
    return out


def _union(spans):
    """Merged [start, end) intervals of ``spans``, sorted."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_profile(intervals, top: int = 10) -> dict:
    """Busy and idle time of the device over the stretch, the device
    operations that took the most time, and the idle gaps summed by the
    innermost harness span the host was in when each gap began."""
    stretch = [(a, b) for name, a, b, dev in intervals
               if name == STRETCH_NAME and not dev]
    if not stretch:
        return {}
    s0, s1 = stretch[0]
    device_ops = [(name, max(a, s0), min(b, s1)) for name, a, b, dev
                  in intervals if dev and b > s0 and a < s1]
    busy = _union([(a, b) for _, a, b in device_ops])
    by_op = collections.Counter()
    for name, a, b in device_ops:
        by_op[name] += (b - a) * 1e-6
    host_spans = sorted((a, b, name[len("portbench."):]) for name, a, b, dev
                        in intervals if not dev and name != STRETCH_NAME
                        and name.startswith("portbench."))
    starts = [a for a, _, _ in host_spans]
    gaps = collections.Counter()
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        label = "harness"
        # the latest-starting span that covers the gap's start: harness
        # spans nest at most a few deep
        for sa, sb, name in reversed(host_spans[max(
                0, bisect.bisect_right(starts, a) - 4):
                bisect.bisect_right(starts, a)]):
            if sa <= a < sb:
                label = name
                break
        gaps[label] += (b - a) * 1e-6
    return {
        "window_s": (s1 - s0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": [[n, s] for n, s in by_op.most_common(top)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
    }


def median(values):
    return statistics.median(values) if values else None
