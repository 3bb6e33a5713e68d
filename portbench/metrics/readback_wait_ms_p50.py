"""Readback (utils/readback.py ``ReadbackRing.read``: the host waiting
for the card's stream, the port's span ``readback.wait``, inside the
CLI's ``read`` in --LatencyMode): the median of the host's milliseconds
per wait over the profiled stretch, a profiled run's times
(``portbench/program_spans.py``).  None where the program has no such
span."""

from portbench import program_spans
from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(program_spans.host_ms("readback.wait"))
