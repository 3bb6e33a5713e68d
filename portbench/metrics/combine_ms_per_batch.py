"""Cost engine (models/cost_engine.py ``_combine``: minSadHad = min(2 SAD,
SATD) after the cost kernels, in the full report only; the port's span
``engine.combine``, which ``compute_batch`` times on the card with CUDA
events): the card's mean milliseconds per batch over the profiled
stretch (``portbench/program_spans.py``), in cells whose costs stay on
the card.  None where the program has no such span."""

from portbench import program_spans


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = program_spans.device_ms("engine.combine")
    return sum(ms) / len(ms) if ms else None
