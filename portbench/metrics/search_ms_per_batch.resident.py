"""Cost engine (MipCostEngine.compute_batch): the card's milliseconds per
batch of the search, from CUDA events around each search of the traced
window, in cells whose costs stay on the card."""


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = trace.device_ms("engine.search")
    return sum(ms) / len(ms) if ms else None
