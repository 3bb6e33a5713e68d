"""Why the card sat idle: a profile's idle gaps put down to the port's
spans.

Reads a chrome trace that ``torch.profiler`` exported
(``prof.export_chrome_trace(path)``, plain or ``.gz``) from a run of the
port, and prints one JSON object: the window (first to last event of the
trace), the device's busy time (the union of its kernels, copies and
sets), and the idle gaps summed by the innermost ``vvc_mip.`` span
(utils/timing.py) open on the host when each gap began, or ``outside``
where none was open.  ``idle_gaps`` labels the (name, start, end, on
the device) intervals of any profile, ``torch.profiler``'s own events
included.

Usage:
    python -m vvc_mip_gpu_tpu_torch.tools.idle_by_span TRACE.json
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json

PREFIX = "vvc_mip."
DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
# ranges the profiler copies from the host onto the device's timeline
DEVICE_COPIES = {"gpu_user_annotation"}


def _union(spans):
    """Merged [start, end) intervals of ``spans``, sorted."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(intervals, window=None) -> dict:
    """The report of one profile: ``intervals`` are (name, start us, end
    us, on the device) of its events, as ``torch.profiler``'s events or
    :func:`chrome_intervals` give them; ``window``: (start, end) in us,
    by default first to last event."""
    intervals = list(intervals)
    if not intervals:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                "idle_gaps": []}
    w0, w1 = window or (min(a for _, a, _, _ in intervals),
                        max(b for _, _, b, _ in intervals))
    busy = _union((max(a, w0), min(b, w1)) for _, a, b, dev in intervals
                  if dev and b > w0 and a < w1)
    # host spans by start, the outer one first where two start together
    spans = sorted(((a, b, name[len(PREFIX):]) for name, a, b, dev
                    in intervals if not dev and name.startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    gaps = collections.Counter()
    active: list[tuple] = []
    i = 0
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        while i < len(spans) and spans[i][0] <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > a]
        gaps[active[-1][2] if active else "outside"] += (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "idle_s": (w1 - w0) * 1e-6 - busy_s,
        "idle_gaps": [[n, s] for n, s in gaps.most_common()],
    }


def chrome_intervals(events: list[dict]) -> list[tuple]:
    """(name, start us, end us, on the device) of a chrome trace's
    complete events, the device's copies of host ranges left out."""
    return [(e["name"], float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0)),
             e.get("cat") in DEVICE_CATEGORIES)
            for e in events if e.get("ph") == "X" and "ts" in e
            and e.get("cat") not in DEVICE_COPIES]


def load(path: str) -> list[dict]:
    """The events of a chrome trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace", help="chrome trace exported by torch.profiler")
    args = p.parse_args(argv)
    print(json.dumps(idle_gaps(chrome_intervals(load(args.trace)))))


if __name__ == "__main__":
    main()
