"""Filters: the least time for one batch's filter (a multiply and an add
per tap, a rounding add and a division per sample; the int32 batch read
once and the int32 result written once; fixed H100 peaks) as a share of
the filter's time per batch from CUDA events, in %."""

from portbench import roofline


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = trace.device_ms("filter")
    cfg = trace.cell.config
    if not ms or cfg["filter"] is None:
        return None
    bound = roofline.filter_bound_ms(cfg["filter"]["type"], cfg["width"],
                                     cfg["height"],
                                     trace.cell.traffic["batch"])
    return 100.0 * bound / (sum(ms) / len(ms))
