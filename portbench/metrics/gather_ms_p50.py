"""Latency engine (parallel/latency_engine.py ``gather``: the joins and
the strided layout's ``cat``, the port's span ``latency.gather``, inside
the CLI's ``read`` in --LatencyMode): the median of the host's
milliseconds per gather over the profiled stretch, a profiled run's
times, which the profiler lengthens most here, where a gather runs ~100
operators (``portbench/program_spans.py``).  None where the program has
no such span."""

from portbench import program_spans
from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(program_spans.host_ms("latency.gather"))
