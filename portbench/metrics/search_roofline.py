"""Cost kernels: the least time the card could take for one batch's
search (the frozen op model over all 17 shape classes, fixed H100 peaks)
as a share of the search's time per batch from CUDA events, in %."""

from portbench import roofline


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = trace.device_ms("engine.search")
    if not ms:
        return None
    cfg = trace.cell.config
    bound = roofline.search_bound_ms(cfg["width"], cfg["height"],
                                     trace.cell.traffic["batch"])
    return 100.0 * bound / (sum(ms) / len(ms))
