"""Readback overlap (utils/readback.py ``PartedRead``: the CLI's step
copies each finished part of a chunk to the pinned ring on a copy stream
while the next part searches; the port's span ``readback.part`` times
each part's copy on that stream): the share of a chunk's copy time that
did not stand exposed after its search, in %.  100 x (1 - the mean
CUDA-event time of the CLI's ``read`` over the window, which covers only
the copy left after the search, / the copy time per read, the sum of
``readback.part``'s card milliseconds over the profiled stretch divided
by the stretch's ``readback.read`` spans, ``portbench/program_spans.py``).
None where the program records no ``readback.part``."""

from portbench import program_spans


def read(trace):
    if trace.entry != "cli_step":
        return None
    parts = program_spans.device_ms("readback.part")
    reads = program_spans.host_ms("readback.read")
    exposed = trace.device_ms("cli.read")
    if not parts or not reads or not exposed:
        return None
    copy_ms = sum(parts) / len(reads)
    return 100.0 * (1.0 - sum(exposed) / len(exposed) / copy_ms)
