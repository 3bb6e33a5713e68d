"""Latency engine (``gather``, the readback ring and ``finish``: the CLI's
``read`` in --LatencyMode): the median of the host's milliseconds per
read over the traced window."""

from portbench.trace import median


def read(trace):
    if trace.entry != "cli_latency":
        return None
    return median(trace.host_ms("latency.assemble"))
