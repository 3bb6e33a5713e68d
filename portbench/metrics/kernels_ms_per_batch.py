"""Cost kernels (models/cost_engine.py ``_run_classes``: the 17 class
launches without the samples' casts, the port's span ``engine.launch``,
which ``compute_batch`` times on the card with CUDA events): the card's
mean milliseconds per batch over the profiled stretch
(``portbench/program_spans.py``), in cells whose costs stay on the card.
None where the program has no such span."""

from portbench import program_spans


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = program_spans.device_ms("engine.launch")
    return sum(ms) / len(ms) if ms else None
