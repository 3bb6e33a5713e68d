"""Filters (ops/filters.py ``filter_frames``): the card's milliseconds per
batch of the low-pass filter, from CUDA events around each batch's
filter, in cells whose costs stay on the card."""


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = trace.device_ms("filter")
    return sum(ms) / len(ms) if ms else None
