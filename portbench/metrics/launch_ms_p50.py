"""Latency engine (models/cost_engine.py ``_run_classes``: the loop of
class launches, the port's span ``engine.launch``, inside the CLI's
``enqueue`` in --LatencyMode): the median of the host's milliseconds per
frame's launches over the profiled stretch, a profiled run's times
(``portbench/program_spans.py``).  None where the program has no such
span."""

from portbench import program_spans
from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(program_spans.host_ms("engine.launch"))
