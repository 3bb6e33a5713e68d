"""Cost engine: the least time the card could take for one batch's
minSadHad combine (SAD and SATD read once, minSadHad written once, int32,
over 3.35 TB/s: ``portbench/roofline_combine.py``) as a share of the
span ``engine.combine``'s card time per batch, in %.  None where the
program has no such span."""

from portbench import program_spans, roofline_combine


def read(trace):
    if trace.entry != "engine_batch":
        return None
    ms = program_spans.device_ms("engine.combine")
    if not ms:
        return None
    cfg = trace.cell.config
    bound = roofline_combine.combine_bound_ms(cfg["width"], cfg["height"],
                                              trace.cell.traffic["batch"])
    return 100.0 * bound / (sum(ms) / len(ms))
