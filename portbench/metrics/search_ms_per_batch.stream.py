"""Cost engine, inside the CLI's per-chunk step (``cli._searcher``'s
``enqueue``): the card's milliseconds per batch of the search, from CUDA
events around each enqueue of the traced window."""


def read(trace):
    if trace.entry != "cli_step":
        return None
    ms = trace.device_ms("cli.search")
    return sum(ms) / len(ms) if ms else None
