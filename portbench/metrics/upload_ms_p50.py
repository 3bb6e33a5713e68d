"""Latency engine (parallel/latency_engine.py ``dispatch``: the frame's
copy to the card, the port's span ``latency.upload``): the median of the
host's milliseconds per upload over the profiled stretch, a profiled
run's times (``portbench/program_spans.py``).  None where the program
has no such span."""

from portbench import program_spans
from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(program_spans.host_ms("latency.upload"))
