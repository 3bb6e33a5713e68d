"""Device: the share of a steady stretch of the traced window in which no
operation ran on the card, from torch.profiler (1 - the union of the
device operations' intervals over the stretch), in %, in cells whose
traffic drives the ``cli_latency`` loop."""


def read(trace):
    if trace.entry != "cli_latency" or not trace.profile:
        return None
    p = trace.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
