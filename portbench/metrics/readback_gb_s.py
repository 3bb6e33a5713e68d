"""Readback (utils/readback.py ``ReadbackRing.read``, inside the CLI's
``read``): bytes read back into host memory over the CUDA-event time of
the reads, in GB/s."""


def read(trace):
    if trace.entry != "cli_step":
        return None
    ms = trace.device_ms("cli.read")
    if not ms or not trace.counters["readback_bytes"]:
        return None
    return trace.counters["readback_bytes"] / 1e9 / (sum(ms) * 1e-3)
