"""Readback (utils/readback.py ``PartedRead.copy_columns``: in the CLI's
--LatencyMode step on one card, the latency engine's ``dispatch`` copies
each SizeId's block of a frame's costs to the pinned ring while the next
SizeId searches): the copies a frame's readback is made of, the count of
the port's spans ``readback.part`` over the count of ``readback.read``
in the profiled stretch (``portbench/program_spans.py``).  None where
the program records no ``readback.part`` there (a frame read back in one
copy after its search)."""

from portbench import program_spans


def read(trace):
    if trace.entry != "cli_latency":
        return None
    parts = program_spans.host_ms("readback.part")
    reads = program_spans.host_ms("readback.read")
    if not parts or not reads:
        return None
    return len(parts) / len(reads)
