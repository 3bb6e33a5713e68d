"""Latency engine (parallel/latency_engine.py ``dispatch``, the CLI's
``enqueue`` in --LatencyMode): the median of the host's milliseconds per
dispatch over the traced window."""

from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(trace.host_ms("latency.dispatch"))
