"""The port's own spans (``vvc_mip_gpu_tpu_torch/utils/timing.py``), as
the ``program_span`` metrics read them: the records of the profiled
stretch only.

The port records its spans while a torch profiler records: in a traced
run, over the stretch of the window and, seconds before it, over the one
profiled warm-up step.  The stretch's records are those from the last
pause of more than ``PAUSE_S`` between one record's end and the next
one's start.  Their host times are a profiled run's: the profiler times
every operator inside a span, so a span that holds many operators reads
longer than it runs untraced.  The functions return None where the
program keeps no such records (a program without the spans).
"""

from __future__ import annotations

from vvc_mip_gpu_tpu_torch.utils import timing

PAUSE_S = 1.0


def stretch_start_ns():
    """The host clock (``time.perf_counter_ns``) at the start of the first
    record of the last profiled stretch, or None."""
    if not hasattr(timing, "spans"):
        return None
    records = sorted(timing.spans(), key=lambda s: s.start_ns)
    if not records:
        return None
    start, end = records[0].start_ns, records[0].end_ns
    for s in records[1:]:
        if s.start_ns - end > PAUSE_S * 1e9:
            start = s.start_ns
        end = max(end, s.end_ns)
    return start


def host_ms(name: str):
    """Host milliseconds of each span ``name`` of the stretch."""
    since = stretch_start_ns()
    return None if since is None else timing.host_ms(name, since)


def device_ms(name: str):
    """Device milliseconds of each span ``name`` of the stretch that timed
    the card's stream (after the card has finished them)."""
    since = stretch_start_ns()
    return None if since is None else timing.device_ms(name, since)
